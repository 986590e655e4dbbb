"""PyTorch / CUDA port of the D-Legion reproduction.

Mirrors the JAX package ``src/repro`` module for module (configs, core,
quant, kernels, legion, models, serve); that package stays the reference
each port module is held against.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.  This package imports torch and
numpy only.
"""

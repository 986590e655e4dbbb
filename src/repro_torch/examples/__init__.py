"""The four example drivers of the port, each run as a module:

    python -m repro_torch.examples.quickstart      [--device cpu]
    python -m repro_torch.examples.serve_bitnet    [--device cpu] ...
    python -m repro_torch.examples.train_bitnet    [--device cpu] ...
    python -m repro_torch.examples.sparsity_dse

They take the JAX package's example scripts' flags and defaults, plus
``--device``, which defaults to the CUDA card and raises without one (the
CPU runs the kernels' plain versions only when asked for).  Each has
``main(argv=None)``; the quickstart's sections are functions that return
their numbers, which its ``main`` prints.
"""

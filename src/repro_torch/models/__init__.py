"""PyTorch model zoo (dense decoder, Mamba-2 and Zamba2-style hybrid
families, BitNet fake-quant)."""
from repro_torch.models.registry import ModelAPI, build_model, make_batch_spec

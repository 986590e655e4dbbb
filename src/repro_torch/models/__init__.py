"""PyTorch model zoo (the dense decoder family so far, BitNet fake-quant)."""
from repro_torch.models.registry import ModelAPI, build_model

"""Device milliseconds a step in PyTorch's elementwise, vectorised and
reduction kernels (fake-quant and its straight-through estimator, AdamW,
norms, activations, casts): every kernel whose function name contains one
of ``PATTERNS``."""

PATTERNS = ("elementwise_kernel", "reduce_kernel")


def read(trace, ctx):
    us = sum(v[1] for name, v in trace["kernels"].items()
             if any(p in name for p in PATTERNS))
    if us <= 0:
        return None
    return us / 1e3 / trace["steps"]

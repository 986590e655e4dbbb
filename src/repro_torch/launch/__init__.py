"""Launch substrate (the port of ``repro.launch``): mesh descriptions, the
H100 roofline, an ATen-level cost counter, the production dry run of every
arch x shape x mesh on DTensor parameters in a fake world, and its report.

The submodules load on first use, so that importing a mesh description
(as ``distributed.sharding`` does) does not import the models.
"""
from repro_torch.launch.mesh import (
    MeshSpec, abstract_mesh, device_mesh, make_host_mesh,
    make_production_mesh,
)

_SUBMODULES = ("dryrun", "hlo_cost", "report", "roofline")

__all__ = ["MeshSpec", "abstract_mesh", "device_mesh", "make_host_mesh",
           "make_production_mesh", *_SUBMODULES]


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"repro_torch.launch.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

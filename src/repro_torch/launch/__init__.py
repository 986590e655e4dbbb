"""Launch substrate: mesh descriptions (the port of ``repro.launch.mesh``).

The JAX package's dry run, HLO cost model and report (``launch/dryrun.py``,
``hlo_cost.py``, ``report.py``) are not ported yet (ROADMAP.md, Queue 1).
"""
from repro_torch.launch.mesh import (
    MeshSpec, abstract_mesh, device_mesh, make_host_mesh,
    make_production_mesh,
)

__all__ = ["MeshSpec", "abstract_mesh", "device_mesh", "make_host_mesh",
           "make_production_mesh"]

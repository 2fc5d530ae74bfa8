"""Launchers, meshes and the analysis tooling over ``torch.distributed``,
mirroring ``repro.launch``: ``mesh`` (``DeviceMesh`` factories and the H100
constants), ``serve`` and ``train`` (``python -m repro_torch.launch.serve``
/ ``.train``), and ``specs``, ``counter``, ``dryrun``, ``roofline`` and
``perf`` (a step counted on fake tensors over a fake process group:
``python -m repro_torch.launch.dryrun`` / ``.roofline`` / ``.perf``)."""
from repro_torch.launch.mesh import make_debug_mesh, make_mesh, make_production_mesh

__all__ = ["make_debug_mesh", "make_mesh", "make_production_mesh"]

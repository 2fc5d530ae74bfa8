"""Launchers and meshes over ``torch.distributed``, mirroring
``repro.launch``: ``mesh`` (``DeviceMesh`` builders and the H100
constants), ``serve`` and ``train`` (``python -m repro_torch.launch.serve``
/ ``.train``)."""
from repro_torch.launch.mesh import make_debug_mesh, make_mesh, make_production_mesh

__all__ = ["make_debug_mesh", "make_mesh", "make_production_mesh"]

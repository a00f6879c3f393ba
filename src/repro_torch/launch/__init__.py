"""Launchers of the port: ``python -m repro_torch.launch.cluster`` (the
batch clustering CLI) and ``python -m repro_torch.launch.serve`` (the
streaming and multi-tenant serving CLI); ``mesh`` holds the mesh
factories and the H100's constants, ``roofline`` the roofline terms."""
from . import mesh, roofline

__all__ = ["mesh", "roofline"]

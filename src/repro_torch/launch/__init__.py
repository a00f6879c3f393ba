"""Launchers of the port: ``python -m repro_torch.launch.cluster`` (the
batch clustering CLI) and ``python -m repro_torch.launch.serve`` (the
streaming and multi-tenant serving CLI)."""

"""Launchers of the port: ``python -m repro_torch.launch.serve`` (the
streaming and multi-tenant serving CLI)."""

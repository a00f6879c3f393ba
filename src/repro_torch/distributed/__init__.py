"""Distributed DBSCAN over the shards of a mesh (the port of
``repro.distributed``): :mod:`sharding` holds the meshes and the slab
geometry; ``ring_dbscan`` holds :func:`tree_dbscan_sharded` and the dense
``ring_dbscan.ring_dbscan``."""
import importlib

from . import sharding

__all__ = ["sharding", "tree_dbscan_sharded"]


def __getattr__(name):
    # ring_dbscan imports the clustering core and the kernels' wrappers;
    # keep that import lazy so `repro_torch.distributed.sharding` stays
    # usable standalone.
    if name == "tree_dbscan_sharded":
        return importlib.import_module(".ring_dbscan",
                                       __name__).tree_dbscan_sharded
    raise AttributeError(name)

"""Hand-written CUDA kernels for the DBSCAN hot spots (+ plain versions).

* ``traverse`` — the walk kernel (``csrc/walk.cu``) behind the single walk
  entry point every clustering phase calls;
* ``pairwise`` — the tile kernels (``csrc/pairwise.cu``), with their plain
  versions in ``ref``;
* ``ops`` — the tiled DBSCAN backend over the tile kernels.
"""
from .pairwise import pairwise_count, pairwise_minlabel
from .ops import dbscan_tiled
from . import ref, traverse

__all__ = ["pairwise_count", "pairwise_minlabel", "dbscan_tiled", "ref",
           "traverse"]

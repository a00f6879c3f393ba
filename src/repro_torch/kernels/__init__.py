"""Hand-written CUDA kernels for the DBSCAN hot spots (+ plain versions).

* ``traverse`` — the walk kernel (``csrc/walk.cu``) behind the single walk
  entry point every clustering phase calls;
* ``knn`` — the k-NN walk kernel (``csrc/knn.cu``) behind
  ``neighbors.knn``;
* ``nodeflags`` — the node-flag kernel (``csrc/nodeflags.cu``) behind the
  frontier sweeps' node masks on the card;
* ``pairwise`` — the tile kernels (``csrc/pairwise.cu``), with their plain
  versions in ``ref``;
* ``ops`` — the tiled DBSCAN backend over the tile kernels.
"""
from .pairwise import pairwise_count, pairwise_minlabel
from .ops import dbscan_tiled
from . import knn, nodeflags, ref, traverse

__all__ = ["pairwise_count", "pairwise_minlabel", "dbscan_tiled", "knn",
           "nodeflags", "ref", "traverse"]

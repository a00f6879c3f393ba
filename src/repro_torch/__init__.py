"""repro_torch: tree-based DBSCAN (FDBSCAN / FDBSCAN-DenseBox) on an H100.

PyTorch and CUDA port of the JAX package ``repro`` (which stays the
reference): Prokopenko, Lebrun-Grandie, Arndt, "Fast tree-based algorithms
for DBSCAN for low-dimensional data on GPUs" (2021). Plain tensor code is
PyTorch; the walk of the tree and the distance tiles are hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` on first use.

Public surface:

  * :func:`dbscan`        — clustering with automatic backend selection
                            (tree walk or distance tiles);
  * :func:`plan`          — backend decision + cached index build, for
                            amortizing eps/min_pts parameter sweeps;
  * :class:`DBSCANResult` — the result record every backend returns.

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""
from .core import DBSCANResult, dbscan, plan

__all__ = ["DBSCANResult", "dbscan", "plan", "__version__"]

__version__ = "0.1.0"

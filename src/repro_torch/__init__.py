"""repro_torch: tree-based DBSCAN (FDBSCAN / FDBSCAN-DenseBox) on an H100.

PyTorch and CUDA port of the JAX package ``repro`` (which stays the
reference): Prokopenko, Lebrun-Grandie, Arndt, "Fast tree-based algorithms
for DBSCAN for low-dimensional data on GPUs" (2021). Plain tensor code is
PyTorch; the walk of the tree and the distance tiles are hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` on first use.

Public surface:

  * :func:`dbscan`        — clustering with automatic backend selection
                            (tree walk, distance tiles, or a one-shot
                            streaming snapshot);
  * :func:`plan`          — backend decision + cached index build, for
                            amortizing eps/min_pts parameter sweeps;
  * :func:`stream_handle` — an online insert/delete/query/snapshot handle
                            over the same cached index, with checkpoints
                            and a write-ahead log (``repro_torch.stream``);
  * :mod:`neighbors`      — fixed-radius counts, k-nearest-neighbor
                            queries, and raw visitor walks over the shared
                            tree index;
  * :class:`DBSCANResult` — the result record every backend returns.

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
``repro_torch.obs`` holds the metrics registry and span tracer the entry
points report into once a collector is installed (``obs.instrumented()``).
"""
from .core import DBSCANResult, dbscan, plan, stream_handle
from .core import neighbors

__all__ = ["DBSCANResult", "dbscan", "plan", "stream_handle", "neighbors",
           "__version__"]

__version__ = "0.1.0"

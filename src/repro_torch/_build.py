"""Build the CUDA kernels with ``nvcc`` and load them through ctypes.

Each source under ``csrc/`` has a plain C interface and compiles on its own
into a shared library for Hopper (``sm_90a``). Builds go into ``_build/``
beside this file (listed in ``.gitignore``), named by a digest of the
source and the flags, so an edited source never loads a stale library.
Nothing is built at import: the first launch of a kernel builds its
library, and :func:`build` starts several ``nvcc`` processes at once for
callers that want every kernel ready up front.

``--fmad=false`` keeps ``nvcc`` from contracting a multiply and an add into
one fused operation: the reference's float32 arithmetic rounds after each
operation, and the kernels must round as it does. A kernel that wants a
fused multiply-add writes it out (``__fmaf_rn``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = {"walk": "walk.cu", "pairwise": "pairwise.cu", "knn": "knn.cu",
           "nodeflags": "nodeflags.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: dict = {}
#: per kernel library: ``{"seconds": wall time of its nvcc, "log": the
#: compiler's report}``, filled by the build that made it in this process
build_info: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=None) -> dict:
    """Compile the named kernel libraries (default: all) that are not built
    yet, one ``nvcc`` per source, all started together. Raises
    ``RuntimeError`` with the compiler's output if any build fails.
    Returns :data:`build_info`."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

"""Run one benchmark cell once on the card and print its result line.

    python3 -m bench.run --workload hacc.fresh --seed 7 --seconds 40 --trace 0

From the root of a checkout. The cell, its configuration, its mix and its
metrics come from ``BENCHMARK.json`` and the files under ``bench/``; the
system under test is ``repro_torch`` from the checkout's ``src/``. The last
line of standard output is the result, a JSON object; the numbers that
decide ``correct`` are the last lines of standard error and the result's
last key. Exits non-zero, printing no result, without a CUDA device (or
with fewer than the cell asks for), without the program in the checkout,
or if JAX or the JAX package was loaded by the time the window closed.
"""
from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (from /proc; 0 if unknown)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        _log(f"no system under test: {src}/repro_torch is missing")
        return 2
    # every cache of the program at a fixed path inside the checkout
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    sys.path.insert(0, src)

    import json
    from pathlib import Path

    import torch

    from bench import harness

    cell = harness.load_cell(Path(root), args.workload)
    if not torch.cuda.is_available():
        _log("no CUDA device")
        return 3
    if torch.cuda.device_count() < cell.chips:
        _log(f"{cell.name} needs {cell.chips} cards; "
             f"{torch.cuda.device_count()} present")
        return 3
    torch.set_num_threads(4)
    _log(f"card: {_card()}")
    result, limits = harness.run(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda:0", T_START, _log)
    bad = forbidden_modules()
    if bad:
        _log(f"loaded in the run: {', '.join(bad)}")
        return 4
    for name, c in limits.items():
        bound = (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
        _log(f"check {name} {c['value']} limit {bound}")
    print(json.dumps(result), flush=True)
    return 0


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


if __name__ == "__main__":
    sys.exit(main())

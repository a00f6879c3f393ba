"""What tracing costs a benchmark cell: the host time of its units with no
collector installed against their time under the benchmark's traced
stretch (``repro_torch.obs.instrumented(sync=True, annotate=False)``).

    python3 tools/trace_cost.py --workload porto.minpts_sweep \
        [--root CHECKOUT] [--seconds 8] [--seed N]

Runs the cell's loop (``bench/loops``) from the checkout ``--root``
(default this one: its ``src/`` is the program, its ``bench/`` the
harness), sets it up once, then times windows of whole periods of the
mix in the order plain, traced, traced, plain. Prints each window's
milliseconds a unit and the cost of tracing, the traced windows' mean
over the plain windows' less one. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 101)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]

    from pathlib import Path

    import torch

    from bench import harness, loops
    from repro_torch import obs
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(Path(root), args.workload)
    dev = torch.device("cuda", 0)
    period = int(cell.mix.get("period", 1))
    with tempfile.TemporaryDirectory() as tmp:
        loop = loops.load(cell.mix["loop"])(cell.cfg, cell.mix, args.seed,
                                            dev, tmp, lambda m: None)
        loop.setup()
        done = [0]

        def window() -> float:
            """Units of whole periods for ``--seconds``: ms a unit."""
            n0, t0 = done[0], time.perf_counter()
            while True:
                loop.unit(done[0])
                done[0] += 1
                if (time.perf_counter() - t0 >= args.seconds
                        and (done[0] - n0) % period == 0):
                    break
            return 1e3 * (time.perf_counter() - t0) / (done[0] - n0)

        plain, traced = [], []
        for kind in ("plain", "traced", "traced", "plain"):
            if kind == "plain":
                plain.append(window())
            else:
                with obs.instrumented(sync=True, annotate=False):
                    traced.append(window())
            print(f"[trace-cost] {args.workload} {kind}: "
                  f"{(plain if kind == 'plain' else traced)[-1]:.3f} ms a "
                  f"unit", flush=True)
        loop.free()
    p, t = sum(plain) / len(plain), sum(traced) / len(traced)
    print(f"[trace-cost] {args.workload} root={args.root} plain {p:.3f} "
          f"traced {t:.3f} ms a unit: tracing costs {100 * (t / p - 1):.2f}%"
          f" ({torch.cuda.get_device_name(dev)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

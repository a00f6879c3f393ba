"""What the observer costs the benchmark's profiled stretch: its wall time,
the device's busy time, the idle share and the idle time that no host
operation names, with the program's span annotations and its metrics
registry each switched on and off.

    python3 tools/profile_cost.py --workload hacc.minpts_sweep \
        [--root CHECKOUT] [--stretches 5] [--seed N] [--out FILE]

Runs the cell's loop (``bench/loops``) from the checkout ``--root``
(default this one: its ``src/`` is the program, its ``bench/`` the
harness), sets it up once, then profiles the mix's ``profile_units``
units at a time under ``torch.profiler`` (host and CUDA activity), as a
traced benchmark run does, in three settings taken in turn (the order
rotated each round), ``--stretches`` times each:

- ``registry+annotations``: a metrics registry installed and the
  program's spans annotating the capture (the benchmark's setting);
- ``registry``: the registry, the spans' annotations switched off;
- ``annotations``: no registry.

A program whose spans do not annotate a capture without a tracer runs
the first two settings alike (an A/A pair). Prints a line a stretch and
a summary a setting (medians, and the quartiles' distance over the
median); writes every stretch as JSON to ``--out``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

SETTINGS = ("registry+annotations", "registry", "annotations")
UNNAMED = "host Python, no torch operation"


def spread(values) -> float:
    """Distance between the first and third quartile over the median."""
    if len(values) < 2:
        return 0.0
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--stretches", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 103)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]

    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench import harness, loops, tracemath
    from repro_torch import obs
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(Path(root), args.workload)
    dev = torch.device("cuda", 0)
    k = int(cell.mix["profile_units"])
    annotate = getattr(obs.trace, "_Annotation", None)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        loop = loops.load(cell.mix["loop"])(cell.cfg, cell.mix, args.seed,
                                            dev, tmp, lambda m: None)
        loop.setup()
        done, failed = [0], [0]

        def stretch(setting: str) -> dict:
            if annotate is not None:
                obs.trace._Annotation = (
                    annotate if "annotations" in setting
                    else lambda name: obs.trace._NOOP)
            reg = (obs.metrics.install() if "registry" in setting
                   else None)
            try:
                torch.cuda.synchronize(dev)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    tp = time.perf_counter()
                    harness._units(loop, k, done, failed, print)
                    torch.cuda.synchronize(dev)
                    wall = time.perf_counter() - tp
            finally:
                if reg is not None:
                    obs.metrics.uninstall()
                if annotate is not None:
                    obs.trace._Annotation = annotate
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            dt = tracemath.DeviceTrace.load(path)
            os.unlink(path)
            busy = dt.busy_s()
            gaps = dict(dt.idle_gaps(*dt.extent(), k=10 ** 6))
            return {"setting": setting, "profiled_s": wall, "busy_s": busy,
                    "idle_share": 100.0 * (1.0 - busy / wall),
                    "unnamed_idle_s": gaps.get(UNNAMED, 0.0),
                    "device_ops": len(dt.device),
                    "annotations": sum(ev.get("cat") == "user_annotation"
                                       for ev in dt.host)}

        stretch(SETTINGS[0])                 # the profiler's own start-up
        for i in range(args.stretches):
            for s in SETTINGS[i % 3:] + SETTINGS[:i % 3]:
                row = stretch(s)
                rows.append(row)
                print(f"[profile-cost] {args.workload} {s}: profiled "
                      f"{row['profiled_s']:.4f} s, busy {row['busy_s']:.4f}"
                      f" s, idle {row['idle_share']:.2f}%, unnamed idle "
                      f"{row['unnamed_idle_s']:.4f} s, "
                      f"{row['device_ops']} device ops, "
                      f"{row['annotations']} annotations", flush=True)
        loop.free()
    print(f"[profile-cost] {args.workload} root={args.root} failed units "
          f"{failed[0]} ({torch.cuda.get_device_name(dev)})")
    for s in SETTINGS:
        mine = [r for r in rows if r["setting"] == s]
        line = []
        for key in ("profiled_s", "busy_s", "idle_share", "unnamed_idle_s"):
            vals = [r[key] for r in mine]
            line.append(f"{key} {statistics.median(vals):.4f} "
                        f"(spread {100 * spread(vals):.2f}%)")
        print(f"[profile-cost] {args.workload} {s}: " + ", ".join(line),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "root": args.root,
                       "device": torch.cuda.get_device_name(dev),
                       "stretches": rows}, f, indent=1)
    return 1 if failed[0] else 0


if __name__ == "__main__":
    sys.exit(main())

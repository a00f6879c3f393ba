"""The control: the plain reference, computed in TF32, put in the program's
place, and judged by the same checks as the program.

    python3 -m bench.control --workload hacc.fresh --seeds 11 12 13
    python3 -m bench.control --workload porto.minpts_sweep --seeds 11 12 \
        --fresh-draws

The configurations state float32 distances with TF32 off; TF32 (each
difference rounded to 10 mantissa bits before it is squared, the rounding
of a TF32 dot product) is the step below that would tempt a faster path.
The control draws the cell's inputs as a run of the cell draws them
(``fresh``: the window's first snapshot; ``resident``: the resident set,
each ``min_pts`` of the sweep; ``stream``: the loop's own books over
``--steps`` steps, the program left out), answers with
``reference.dbscan_ref.solve`` and ``stream_ref.answer_queries`` in TF32,
and prints the numbers that decide ``correct``, one JSON line a seed. The
benchmark's own runs never run it.

With ``--fresh-draws`` it runs the program instead, on a resident cell's
loop over a set drawn anew from each seed (``data_seed`` set to the seed)
in place of the configuration's one draw: one call of each ``min_pts`` at
full size, judged by the run's own checks.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import harness, loops
from .reference import dbscan_ref, stream_ref

LOWER = "tf32"


def control(cell: harness.Cell, seed: int, device, steps: int = 16,
            log=None) -> dict:
    """The compared numbers of the control on ``seed`` (a dict, as a run's
    ``checks``)."""
    log = log or (lambda m: None)
    dev = torch.device(device)
    loop = loops.load(cell.mix["loop"])(cell.cfg, cell.mix, seed, dev,
                                        tempfile.gettempdir(), log)
    out: dict = {}
    kind = cell.mix["loop"]
    if kind in ("fresh", "resident"):
        pts = (loop.resident_points() if kind == "resident"
               else loop.draw(loop.n, loops.DRAW, 0))
        sweep = ([loop.min_pts] if kind == "fresh"
                 else [int(m) for m in cell.cfg["min_pts_sweep"]])
        for m in sweep:
            labels, core, nc = dbscan_ref.solve(pts, loop.eps, m, LOWER)
            got = dbscan_ref.check_clustering(pts, loop.eps, m, labels,
                                              core, nc, loop.rounding)
            loops.add_checks(out, got)
            log(f"control min_pts {m}: {loops.brief(got)}")
        out["calls_checked"] = len(sweep)
        return out
    loop.dry = True
    loop.setup()
    for t in range(1, steps + 1):
        loop.step(t)
    t, probes, _ = loop.last
    gids = loop.alive(loop.total)
    pts = torch.cat(loop.batches)[gids]
    labels, core, nc = dbscan_ref.solve(pts, loop.eps, loop.min_pts, LOWER)
    got = dbscan_ref.check_clustering(pts, loop.eps, loop.min_pts, labels,
                                      core, nc, loop.rounding)
    loops.add_checks(out, got)
    log(f"control snapshot after step {t}: {loops.brief(got)}")
    comp = dbscan_ref.components(pts, core, loop.eps, [(LOWER,)])[0]
    ql, qc, qw = stream_ref.answer_queries(pts, gids, core, comp, probes,
                                           loop.eps, loop.min_pts, LOWER)
    _, rcore, comps = got["_state"]
    out.update(stream_ref.check_queries(
        pts, gids, rcore, comps, probes, ql, qc, qw, loop.eps,
        loop.min_pts, loop.rounding))
    out["steps_checked"] = 1
    loop.free()
    return out


def fresh_draw(cell: harness.Cell, seed: int, device, log=None) -> dict:
    """The compared numbers of the program on a resident set drawn from
    ``seed``: one call of each ``min_pts`` of the sweep, through the
    cell's own loop and checks."""
    log = log or (lambda m: None)
    cfg = dict(cell.cfg, data_seed=int(seed))
    loop = loops.load(cell.mix["loop"])(cfg, cell.mix, seed,
                                        torch.device(device),
                                        tempfile.gettempdir(), log)
    loop.setup()
    for i in range(len(loop.sweep)):
        loop.unit(i)
    out = loop.checks()
    loop.free()
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--fresh-draws", action="store_true")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root / "src"))
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(root, args.workload)
    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        got = (fresh_draw(cell, seed, "cuda:0", log) if args.fresh_draws
               else control(cell, seed, "cuda:0", args.steps, log))
        limits = harness.limits_of(got)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "run": ("program, fresh draw" if args.fresh_draws
                                  else "control"),
                          "correct": harness.passes(limits),
                          "seconds": time.perf_counter() - t0,
                          "checks": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

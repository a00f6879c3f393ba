"""How much of a benchmark configuration's resident set lies in dense
cells, by ``min_pts`` of its sweep.

    python3 tools/dense_cells.py [--config ngsim] [--device cuda]

Draws the configuration's resident point set as the sweep cells draw it
(``bench/configs/<config>.json``, its ``data_seed``) and bins it into
square cells of side ``eps / sqrt(d)``, the cells DenseBox collapses (any
two points in one are within eps). Prints one JSON line: the cell count,
the largest cell, the cell of the median point, and per ``min_pts`` the
share of points in cells of at least that many points, with the number
of such cells. Plain torch: the program is not run.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench import data  # noqa: E402


def dense_cells(pts: torch.Tensor, eps: float, sweep) -> dict:
    """Cell statistics of ``pts`` binned at side ``eps / sqrt(d)``."""
    x = pts.double()
    c = torch.floor((x - x.min(0).values) / (eps / math.sqrt(x.shape[1])))
    _, inv, count = torch.unique(c.long(), dim=0, return_inverse=True,
                                 return_counts=True)
    per_point = count[inv]
    out = {"n": pts.shape[0], "cells": count.numel(),
           "largest_cell": int(count.max()),
           "median_point_cell": int(per_point.median()), "by_min_pts": {}}
    for m in sweep:
        out["by_min_pts"][str(m)] = {
            "dense_share": float((per_point >= m).double().mean()),
            "dense_cells": int((count >= m).sum())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="ngsim")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "bench", "configs",
                           f"{args.config}.json")) as f:
        cfg = json.load(f)
    pts = data.draw(cfg, data.catalog(cfg), int(cfg["n"]),
                    data.derive_seed(int(cfg["data_seed"])), args.device)
    got = dense_cells(pts, float(cfg["eps"]), cfg["min_pts_sweep"])
    print(json.dumps(dict(got, config=args.config)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

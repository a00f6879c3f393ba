"""The traffic generator: one closed loop per kind of mix, one file a kind.

A mix file (``bench/mixes/<name>.json``) names its ``loop``, the kind,
and gives its parameters; the kind is the file ``bench/loops/<loop>.py``,
found by that name, whose class ``Loop`` runs it. A configuration file
gives the data set and the DBSCAN parameters. Each loop has one caller
that waits for every answer, draws its inputs from ``--seed`` alone, keeps
a sample of its answers drawn from the seed, and after the window judges
them with the plain reference (``bench/reference``). Adding a kind of
traffic adds a file here.

A ``Loop`` has ``setup()`` (counted as set-up), ``unit(i)`` (one call or
step of the window), ``checks()`` (the compared numbers, after the
window) and ``free()``; ``work_of(i)`` gives the operations and bytes a
profiled unit needed, where the checks counted them.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import data

# Salts that keep the seeded streams of one run apart.
DRAW, WARM, KEEP, BATCH, SAMPLE = 0, 1, 2, 3, 6

# The violation counts of a clustering that ``correct`` holds at 0.
CLUSTER_CHECKS = ("core_mismatch", "core_unlabeled", "clusters_split",
                  "clusters_merged", "label_errors", "border_errors")


def load(kind: str):
    """The ``Loop`` class of mix kind ``kind`` (``bench/loops/<kind>.py``)."""
    return data.find("loops", kind).Loop


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rounding_of(cfg: dict, mix: dict) -> tuple:
    """The roundings the answers are held to: the configuration's, plus
    any that the mix's path also uses."""
    base = [cfg["guarantee"]["distance_rounding"]]
    return tuple(base + [r for r in mix.get("also_rounding", [])
                         if r not in base])


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from a seeded generator."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


def add_checks(total: dict, part: dict) -> None:
    for k in CLUSTER_CHECKS:
        total[k] = total.get(k, 0) + part[k]


def brief(got: dict) -> str:
    return " ".join(f"{k}={got[k]}" for k in CLUSTER_CHECKS) + \
        f" ref={got['_ref']}"


class BaseLoop:
    """What every loop shares: its inputs, the program, the checks."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, tmpdir,
                 log):
        import repro_torch
        self.repro_torch = repro_torch
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.tmpdir = tmpdir
        self.log = log
        self.n, self.d = int(cfg["n"]), int(cfg["d"])
        self.eps, self.min_pts = float(cfg["eps"]), int(cfg["min_pts"])
        self.rounding = rounding_of(cfg, mix)
        self.catalog = data.catalog(cfg)
        self.gen_s = 0.0

    def draw(self, n: int, *salt) -> torch.Tensor:
        t = time.perf_counter()
        pts = data.draw(self.cfg, self.catalog, n,
                        data.derive_seed(self.seed, *salt), self.device)
        sync(self.device)
        self.gen_s += time.perf_counter() - t
        return pts

    def dbscan(self, pts, min_pts):
        return self.repro_torch.dbscan(pts, self.eps, min_pts,
                                       device=self.device)

    def work_of(self, i: int):
        """(operations, bytes) that window unit ``i`` needed, where the
        checks counted them; else None."""
        return None

    def release(self) -> None:
        """Drop the program's plans (its plan cache), keeping the answers
        to be judged."""
        from repro_torch.core import dispatch
        dispatch.clear_cache()
        gc.collect()

    def free(self) -> None:
        self.release()

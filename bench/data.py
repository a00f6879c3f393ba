"""Surrogate point clouds of the paper's data sets, drawn with torch on the
device from a seed.

A configuration names its generator (``generator.name``); the generator
is the file ``bench/generators/<name>.py`` (frozen copies of the port's
numpy generators), found by that name. Each splits in two:

* the *catalog* (halo centres and masses; blob centres, weights and
  scales) is what the original draws first from its default seed. It is
  recomputed with numpy's generator exactly as the original draws it, so
  a configuration names one fixed universe;
* the *particles* are drawn with a ``torch.Generator`` on the device, in a
  few large calls, from a seed that the caller derives from ``--seed`` and
  a step. Every seed thus gives a set of the same sizes and density
  regime, and a different draw of it.
"""
from __future__ import annotations

import importlib
import re

import numpy as np
import torch

_MASK63 = (1 << 63) - 1
_MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def derive_seed(*parts: int) -> int:
    """A 63-bit generator seed from ``parts`` (the run's ``--seed``, a salt
    and a step), by numpy's ``SeedSequence``: equal parts give equal
    seeds, and neighbouring parts give unrelated streams."""
    ss = np.random.SeedSequence([int(p) & ((1 << 64) - 1) for p in parts])
    return int(ss.generate_state(1, dtype=np.uint64)[0]) & _MASK63


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def find(package: str, name: str):
    """The module ``bench/<package>/<name>.py``, found by its name."""
    if not _MODULE.match(name):
        raise ValueError(f"{name!r} is not a module name")
    return importlib.import_module(f"bench.{package}.{name}")


def pick(weights: torch.Tensor, m: int, g: torch.Generator) -> torch.Tensor:
    """``m`` draws of an index with probabilities ``weights`` (inverse CDF
    of uniform draws, as ``Generator.choice`` does)."""
    cdf = torch.cumsum(weights.double(), 0)
    cdf = cdf / cdf[-1]
    u = torch.rand(m, generator=g, device=weights.device,
                   dtype=torch.float64)
    return torch.searchsorted(cdf, u, right=True).clamp_max(
        weights.numel() - 1)


def catalog(cfg: dict) -> dict:
    """The catalog a configuration names (``cfg["generator"]``)."""
    gen = cfg["generator"]
    return find("generators", gen["name"]).catalog(cfg["n"],
                                                   **gen["params"])


def draw(cfg: dict, cat: dict, n: int, seed: int, device) -> torch.Tensor:
    """``n`` points of configuration ``cfg`` from generator seed ``seed``."""
    gen = cfg["generator"]
    return find("generators", gen["name"]).draw(
        cat, n, generator(seed, device), device, **gen["params"])

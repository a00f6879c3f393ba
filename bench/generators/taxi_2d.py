"""PortoTaxi-like GPS points: heavy-tailed urban blobs.

A frozen copy of ``repro_torch.data.pointclouds.taxi_2d``. The catalog
(blob centres, Pareto weights and scales) is the original's first draw
from its seed; the points follow the original, drawn with torch on the
device: blob membership by weight and a Gaussian offset scaled by the
blob's scale.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.data import pick


def catalog(n: int, k: int = 30, seed: int = 2) -> dict:
    """Blob centres, weights and scales of ``taxi_2d(n, k, seed)``. The
    original draws the scales after the ``n`` memberships, so those are
    drawn (and dropped) here too: the scales depend on ``n``."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, size=(k, 2))
    weights = rng.pareto(1.5, size=k) + 0.1
    weights /= weights.sum()
    rng.choice(k, size=n, p=weights)
    scales = rng.uniform(0.002, 0.05, size=k)
    return {"centers": centers, "weights": weights, "scales": scales}


def draw(cat: dict, n: int, g: torch.Generator, device,
         **_) -> torch.Tensor:
    """``n`` points (float32, on ``device``)."""
    dev = torch.device(device)
    centers = torch.as_tensor(cat["centers"], dtype=torch.float64,
                              device=dev)
    weights = torch.as_tensor(cat["weights"], dtype=torch.float64,
                              device=dev)
    scales = torch.as_tensor(cat["scales"], dtype=torch.float64, device=dev)
    which = pick(weights, n, g)
    noise = torch.randn(n, 2, generator=g, device=dev, dtype=torch.float64)
    pts = centers[which] + noise * scales[which, None]
    return pts.to(torch.float32).contiguous()

"""HACC-like particles: NFW-like halos over a uniform background.

A frozen copy of ``repro_torch.data.pointclouds.halos_3d``. The catalog
(halo centres and mass shares) is the original's first draw from its
seed; the particles follow the original step for step, drawn with torch
on the device: halo membership by mass, radius ``r_max * sqrt(u)`` with
``u`` uniform on ``[1e-4, 1)`` (a density falling as ``1/r``), a uniform
direction, then the uniform background.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.data import pick


def catalog(n: int, n_halos: int = 50, background_frac: float = 0.5,
            seed: int = 3) -> dict:
    """Halo centres and mass shares of ``halos_3d(n, n_halos,
    background_frac, seed)``, drawn as the original draws them."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, size=(n_halos, 3))
    mass = rng.pareto(1.2, size=n_halos) + 0.05
    mass /= mass.sum()
    return {"centers": centers, "weights": mass}


def draw(cat: dict, n: int, g: torch.Generator, device,
         background_frac: float = 0.5, r_max: float = 0.02,
         **_) -> torch.Tensor:
    """``n`` points (float32, on ``device``): halo particles first, then
    the uniform background, as the original orders them."""
    dev = torch.device(device)
    n_bg = int(n * background_frac)
    n_h = n - n_bg
    centers = torch.as_tensor(cat["centers"], dtype=torch.float64,
                              device=dev)
    weights = torch.as_tensor(cat["weights"], dtype=torch.float64,
                              device=dev)
    which = pick(weights, n_h, g)
    u = torch.rand(n_h, generator=g, device=dev, dtype=torch.float64)
    r = r_max * torch.sqrt(1e-4 + (1 - 1e-4) * u)
    direction = torch.randn(n_h, 3, generator=g, device=dev,
                            dtype=torch.float64)
    direction = direction / torch.linalg.vector_norm(direction, dim=1,
                                                     keepdim=True)
    halo = centers[which] + direction * r[:, None]
    bg = torch.rand(n_bg, 3, generator=g, device=dev, dtype=torch.float64)
    return torch.cat([halo, bg]).to(torch.float32).contiguous()

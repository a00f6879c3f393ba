"""NGSIM-like vehicle positions: dense lane strips over a study section.

A frozen copy of ``repro_torch.data.pointclouds.trajectories_2d``. The
catalog is the lanes' geometry, which the original fixes in its code (it
draws nothing but the points from its seed): lane ``k`` follows
``y = amplitude * sin(omega * x + phases[k]) + offsets[k]`` for ``x`` in
``[0, 1)``, and the last ``n - lanes * (n // lanes)`` points fill the box
``[0, 1) x [0, 0.15)`` (``rest_box``). The points follow the original step for step,
drawn with torch on the device: per lane, ``n // lanes`` positions along
the section uniform in ``x``, each moved by a Gaussian offset of
``sigma`` on both axes; lanes in order, then the remainder.
"""
from __future__ import annotations

import torch


def catalog(n: int, n_lanes: int = 6) -> dict:
    """The lane geometry of ``trajectories_2d(n, n_lanes)``, as the
    original's code states it (the same at every ``n``)."""
    return {"phases": [float(k) for k in range(n_lanes)],
            "offsets": [k * 0.02 for k in range(n_lanes)],
            "amplitude": 0.05, "omega": 6.28, "sigma": 5e-4,
            "rest_box": [1.0, 0.15]}


def draw(cat: dict, n: int, g: torch.Generator, device,
         **_) -> torch.Tensor:
    """``n`` points (float32, on ``device``): each lane's points in turn,
    then the uniform remainder, as the original orders them."""
    dev = torch.device(device)
    n_lanes = len(cat["phases"])
    per = n // n_lanes
    f64 = dict(dtype=torch.float64, device=dev)
    phase = torch.tensor(cat["phases"], **f64)[:, None]
    offset = torch.tensor(cat["offsets"], **f64)[:, None]
    t = torch.rand(n_lanes, per, generator=g, **f64)
    y = cat["amplitude"] * torch.sin(cat["omega"] * t + phase) + offset
    lanes = torch.stack([t, y], -1)
    lanes += torch.randn(n_lanes, per, 2, generator=g, **f64) * cat["sigma"]
    rest = n - per * n_lanes
    box = torch.tensor(cat["rest_box"], **f64)
    tail = torch.rand(rest, 2, generator=g, **f64) * box
    pts = torch.cat([lanes.reshape(-1, 2), tail])
    return pts.to(torch.float32).contiguous()

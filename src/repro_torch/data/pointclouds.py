"""Surrogate point-cloud generators matching the paper's dataset regimes.

The paper's exact datasets (NGSIM trajectories, PortoTaxi, 3D Road, HACC
cosmology) are not redistributable in this offline container; these
generators produce statistically analogous surrogates with matched density
regimes. The benchmark harness accepts real files when present
(``--data path.npy``).

* ``trajectories_2d``  — NGSIM-like: a few extremely dense lane strips
  (>95% of points fall into dense cells, the regime where DenseBox wins).
* ``road_network_2d``  — 3D-Road-like: sparse polyline graph with noise.
* ``taxi_2d``          — PortoTaxi-like: heavy-tailed urban blob mixture.
* ``halos_3d``         — HACC-like: NFW-ish halos over a uniform background,
  sparse and evenly spread (the regime where plain FDBSCAN wins at high
  minpts — paper Fig. 6).
* ``blobs``            — generic Gaussian mixture for unit tests.
"""
from __future__ import annotations

import numpy as np


def blobs(n: int, d: int = 2, k: int = 5, spread: float = 0.03,
          seed: int = 0, noise_frac: float = 0.1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 1.0, size=(k, d))
    n_noise = int(n * noise_frac)
    n_sig = n - n_noise
    which = rng.integers(0, k, size=n_sig)
    pts = centers[which] + rng.normal(0.0, spread, size=(n_sig, d))
    noise = rng.uniform(-0.2, 1.2, size=(n_noise, d))
    return np.concatenate([pts, noise]).astype(np.float32)


def trajectories_2d(n: int, n_lanes: int = 6, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    per = n // n_lanes
    out = []
    for lane in range(n_lanes):
        t = rng.uniform(0, 1, size=(per,))
        base = np.stack([t, 0.05 * np.sin(6.28 * t + lane) + lane * 0.02], -1)
        out.append(base + rng.normal(0, 5e-4, size=base.shape))
    rest = n - per * n_lanes
    if rest:
        out.append(rng.uniform(0, 1, size=(rest, 2)) * [1.0, 0.15])
    return np.concatenate(out).astype(np.float32)


def road_network_2d(n: int, n_roads: int = 40, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nodes = rng.uniform(0, 1, size=(n_roads + 1, 2))
    out = []
    per = n // n_roads
    for r in range(n_roads):
        a, b = nodes[r], nodes[(r + rng.integers(1, n_roads)) % n_roads]
        t = np.sort(rng.uniform(0, 1, size=(per,)))[:, None]
        seg = a * (1 - t) + b * t
        out.append(seg + rng.normal(0, 2e-3, size=seg.shape))
    rest = n - per * n_roads
    if rest:
        out.append(rng.uniform(0, 1, size=(rest, 2)))
    return np.concatenate(out).astype(np.float32)


def taxi_2d(n: int, k: int = 30, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, size=(k, 2))
    weights = rng.pareto(1.5, size=k) + 0.1
    weights /= weights.sum()
    which = rng.choice(k, size=n, p=weights)
    scales = rng.uniform(0.002, 0.05, size=k)
    pts = centers[which] + rng.normal(size=(n, 2)) * scales[which, None]
    return pts.astype(np.float32)


def halos_3d(n: int, n_halos: int = 50, background_frac: float = 0.5,
             seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_bg = int(n * background_frac)
    n_h = n - n_bg
    centers = rng.uniform(0, 1, size=(n_halos, 3))
    mass = rng.pareto(1.2, size=n_halos) + 0.05
    mass /= mass.sum()
    which = rng.choice(n_halos, size=n_h, p=mass)
    # NFW-ish: radius ~ r^{-1} density falloff via inverse-CDF sampling
    u = rng.uniform(1e-4, 1, size=n_h)
    r = 0.02 * np.sqrt(u)
    direction = rng.normal(size=(n_h, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    pts = centers[which] + direction * r[:, None]
    bg = rng.uniform(0, 1, size=(n_bg, 3))
    return np.concatenate([pts, bg]).astype(np.float32)


DATASETS = {
    "ngsim_like": trajectories_2d,
    "portotaxi_like": taxi_2d,
    "road3d_like": road_network_2d,
    "hacc_like": halos_3d,
    "blobs": blobs,
}


def load(name: str, n: int, seed: int = 0) -> np.ndarray:
    if name.endswith(".npy"):
        pts = np.load(name)[:n]
        return np.asarray(pts, np.float32)
    return DATASETS[name](n, seed=seed)

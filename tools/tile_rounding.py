"""How the reference's tile kernels round their squared distances, by d.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/tile_rounding.py [d ...]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/tile_rounding.py --hlo d

Runs the reference's own tile distance (``_tile_dist2`` of
src/repro/kernels/pairwise.py) inside a Pallas kernel in interpret mode on
the host, on one 128 x 128 tile of random normal points, and counts the
entries whose float32 bits differ from two plain versions of the port:

  * ``chain``: both norms and the dot product as the first axis's product
    then one fused multiply-add per axis (``core/lbvh.py: sum_sq``);
  * ``tile``: the norms as ``kernels/ref.py: tile_sum_sq`` rounds them
    (the chain at d <= 4 and 9..32, unfused at 5..8, windows of 32 above),
    the dot product as the chain.

Then, on boundary-grid data (300 points on a {0, 0.1, 0.2} grid with 1e-7
jitter, eps on the median distance shell, as ``tests/test_torch_pairwise.py``
makes it above d = 3), it counts the queries where each plain version's count
and min-label differ from the reference's Pallas kernels. Prints one line
per d. Default widths: 2 3 5 8 16 17 32 33 48 64 65 100. With ``--hlo d``
it prints instead the reductions and reduce-windows of the compiled
reference at width d, where the splitting of the norm can be read.
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental import pallas as pl

from repro.kernels import pairwise as jpairwise
from repro_torch.core.lbvh import fma_f32, sum_sq
from repro_torch.kernels import ref

TILE = 128


def _d2_kernel(q_ref, r_ref, o_ref):
    o_ref[...] = jpairwise._tile_dist2(q_ref[...], r_ref[...])


@jax.jit
def reference_d2(q, r):
    """The reference's (TILE, TILE) squared distances, in a Pallas kernel
    run in interpret mode."""
    d = q.shape[1]
    return pl.pallas_call(
        _d2_kernel, grid=(1, 1),
        in_specs=[pl.BlockSpec((TILE, d), lambda i, j: (i, 0)),
                  pl.BlockSpec((TILE, d), lambda i, j: (j, 0))],
        out_specs=pl.BlockSpec((TILE, TILE), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((TILE, TILE), jnp.float32),
        interpret=True)(q, r)


def _dist2(q, r, norm):
    cross = q[:, None, 0] * r[None, :, 0]
    for k in range(1, q.shape[1]):
        cross = fma_f32(q[:, None, k], r[None, :, k], cross)
    return (norm(q)[:, None] + norm(r)[None, :]) - 2.0 * cross


NORMS = {"chain": sum_sq, "tile": ref.tile_sum_sq}


def tile_mismatches(d: int) -> dict:
    rng = np.random.default_rng(d)
    q, r = (rng.standard_normal((TILE, d)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(reference_d2(q, r)).view(np.int32)
    tq, tr = torch.from_numpy(q), torch.from_numpy(r)
    return {name: int((_dist2(tq, tr, norm).numpy().view(np.int32)
                       != want).sum()) for name, norm in NORMS.items()}


def grid_mismatches(d: int) -> dict:
    """Queries of the boundary-grid data whose count, min-label or
    min-label count differ from the reference's Pallas kernels."""
    rng = np.random.default_rng(d)
    cells = rng.integers(0, 3, (300, d))
    pts = (cells * np.float32(0.1)
           + rng.uniform(-1e-7, 1e-7, (300, d))).astype(np.float32)
    eps = 0.1 * float(np.sqrt(np.median(
        ((cells[:, None] - cells[None]) ** 2).sum(-1))))
    labels = rng.permutation(300).astype(np.int32)
    mask = rng.random(300) < 0.7
    want_c = np.asarray(jpairwise.pairwise_count(pts, pts, eps))
    want_l, want_m = (np.asarray(x) for x in jpairwise.pairwise_minlabel(
        pts, pts, labels, mask, eps))
    t = torch.from_numpy(pts)
    out = {}
    for name, norm in NORMS.items():
        ok = _dist2(t, t, norm) <= np.float32(eps) * np.float32(eps)
        cnt = ok.sum(1).numpy()
        okm = ok & torch.from_numpy(mask)[None, :]
        lab = torch.where(okm, torch.from_numpy(labels)[None, :],
                          ref.INT_MAX).amin(1).numpy()
        out[name] = (int((cnt != want_c).sum()), int((lab != want_l).sum()),
                     int((okm.sum(1).numpy() != want_m).sum()))
    out["mean_neighbours"] = float(want_c.mean())
    return out


def print_hlo(d: int) -> None:
    x = np.zeros((TILE, d), np.float32)
    for line in reference_d2.lower(x, x).compile().as_text().splitlines():
        if " reduce(" in line or " reduce-window(" in line:
            print(line.strip()[:160])


def main() -> None:
    if sys.argv[1:2] == ["--hlo"]:
        print_hlo(int(sys.argv[2]))
        return
    widths = [int(a) for a in sys.argv[1:]] or [2, 3, 5, 8, 16, 17, 32, 33,
                                                 48, 64, 65, 100]
    print("d  tile entries differing (of 16384): chain, tile | boundary "
          "grid, queries differing (count, min-label, min-label count): "
          "chain, tile | mean neighbours")
    for d in widths:
        tm, gm = tile_mismatches(d), grid_mismatches(d)
        print(f"{d:3d}  {tm['chain']:5d} {tm['tile']:5d} | {gm['chain']} "
              f"{gm['tile']} | {gm['mean_neighbours']:.1f}", flush=True)


if __name__ == "__main__":
    main()

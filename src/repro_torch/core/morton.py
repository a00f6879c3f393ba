"""Morton (Z-order) codes for low-dimensional points.

The LBVH construction (Karras 2012) requires primitives sorted along a
space-filling curve. Coordinates are quantized to a fixed per-dimension bit
budget (16 bits/dim for 2D, 10 bits/dim for 3D, so a code fits in 32 bits)
and the bits are interleaved with the classic magic-number spreads.

Codes are held in ``int64`` tensors carrying the unsigned 32-bit value:
torch's ``uint32`` lacks shifts and bitwise ops on several backends, and
every value here stays below 2**32, so the int64 arithmetic is exact and
orders exactly as the uint32 codes do.
"""
from __future__ import annotations

import torch

BITS_2D = 16
BITS_3D = 10


def _expand_bits_2d(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of ``v`` so there is a 0 bit between each."""
    v = v & 0x0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _expand_bits_3d(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` so there are 2 zero bits in between."""
    v = v & 0x000003FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def f32(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 tensor on ``like``'s device.

    Dividing by a Python number is not exact IEEE division everywhere:
    CUDA multiplies by the reciprocal of a host scalar, and
    ``number / tensor`` is ``reciprocal(tensor) * number`` on every device.
    Every division on the index path therefore goes through a device
    tensor, which rounds exactly like the reference's float32 division.
    """
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize(points: torch.Tensor, n_bits: int, lo=None,
             hi=None) -> torch.Tensor:
    """Quantize ``points`` (n, d) into int64 grid coords in [0, 2**n_bits)."""
    if lo is None:
        lo = points.amin(0)
    if hi is None:
        hi = points.amax(0)
    extent = torch.clamp_min(hi - lo, torch.finfo(points.dtype).tiny)
    scale = f32(2.0**n_bits - 1.0, points) / extent
    q = torch.floor((points - lo) * scale)
    q = torch.clamp(q, 0.0, 2.0**n_bits - 1.0)
    return q.to(torch.int64)


def morton_encode(points: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """Morton codes (int64 holding the uint32 value) for (n, 2) or (n, 3)
    float32 points.

    ``lo``/``hi`` override the quantization bounds (default: the data's own
    extent). The streaming index passes the bounds of a level's real
    points, so its padding sentinels clip to the top cell instead of
    stretching the grid."""
    d = points.shape[-1]
    if d == 2:
        q = quantize(points, BITS_2D, lo, hi)
        return (_expand_bits_2d(q[:, 0]) << 1) | _expand_bits_2d(q[:, 1])
    if d == 3:
        q = quantize(points, BITS_3D, lo, hi)
        return ((_expand_bits_3d(q[:, 0]) << 2)
                | (_expand_bits_3d(q[:, 1]) << 1)
                | _expand_bits_3d(q[:, 2]))
    raise ValueError(f"morton_encode supports d in (2, 3); got d={d}")


def morton_sort(points: torch.Tensor):
    """Sort points along the Z-curve.

    Returns (sorted_points, order, sorted_codes); ``order[i]`` (int32) is
    the original index of sorted position i. The sort is stable, so equal
    codes keep their original relative order (the LBVH delta function
    breaks ties by index, which this keeps consistent).
    """
    codes = morton_encode(points)
    order = torch.argsort(codes, stable=True)
    return points[order], order.to(torch.int32), codes[order]

"""The tile kernels: neighbor counts and min-label gathers over all pairs.

``csrc/pairwise.cu`` holds the hand-written counterparts of the Pallas
kernels ``count_kernel`` and ``minlabel_kernel``
(src/repro/kernels/pairwise.py). Each wrapper launches its kernel for CUDA
tensors and takes the plain version in ``ref.py`` only for CPU tensors.
Both take points of any width d >= 1. Inputs of any floating dtype (fp16,
fp32, fp64) are cast to float32 first, as the reference casts them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.core.traversal import radius2
from . import ref

INT_MAX = ref.INT_MAX
SPLITS = (1, 2, 4, 8)   # warps a query: the block's 8 warps serve 8 / split

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    lib = _build.load("pairwise")
    lib.pairwise_count_launch.argtypes = [_P, _P, _I, _I, _I, _F, _I, _I, _P,
                                          _P]
    lib.pairwise_count_launch.restype = ctypes.c_int
    lib.pairwise_minlabel_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _F,
                                             _I, _P, _P, _P]
    lib.pairwise_minlabel_launch.restype = ctypes.c_int
    return lib


def _points(q, r, what):
    """Checked contiguous float32 copies of the query/reference points."""
    for name, x in (("points_q", q), ("points_r", r)):
        if not isinstance(x, torch.Tensor) or not x.is_floating_point():
            raise TypeError(f"{what}: {name} must be a floating tensor")
        if x.dim() != 2:
            raise ValueError(f"{what}: {name} must be (n, d); got "
                             f"{tuple(x.shape)}")
    if q.device != r.device:
        raise ValueError(f"{what}: points on {q.device} and {r.device}")
    if q.shape[1] != r.shape[1]:
        raise ValueError(f"{what}: d differs ({q.shape[1]} vs {r.shape[1]})")
    return (q.to(torch.float32).contiguous(),
            r.to(torch.float32).contiguous())


def _check_card(q, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: the kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.shape[1] < 1:
        raise ValueError(f"{what}: the kernel takes d >= 1, got "
                         f"d={q.shape[1]}")


def warps_per_query(nq: int, nr: int, d: int) -> int:
    """How many warps share a query's references (one of ``SPLITS``): the
    fewest that give the launch about 16 warps on each of the H100's 132
    SMs (8 above d = 4, where a thread carries at most 8 / split dot
    products across a tile's chunks, so a smaller share of a tile costs
    more), and never more than the references keep busy (32 a warp)."""
    wanted = 132 * (16 if d <= 4 else 8)
    split = 1
    while split < SPLITS[-1] and nq * split < wanted and 32 * split < nr:
        split *= 2
    return split


def pairwise_count(points_q, points_r, eps, cap: int = INT_MAX):
    """(nq,) int32: references within eps of each query, saturated at cap."""
    if points_q.device.type == "cpu":
        return ref.pairwise_count_ref(points_q, points_r, eps, cap)
    q, r = _points(points_q, points_r, "pairwise_count")
    _check_card(q, "pairwise_count")
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:             # nothing to launch, nothing counted
        return out
    err = _lib().pairwise_count_launch(
        q.data_ptr(), r.data_ptr(), q.shape[0], r.shape[0], q.shape[1],
        radius2(eps), int(cap),
        warps_per_query(q.shape[0], r.shape[0], q.shape[1]), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "pairwise_count")
    pairwise_count.launches += 1
    return out


def pairwise_minlabel(points_q, points_r, labels_r, mask_r, eps):
    """(min masked label within eps, matched count) per query, (nq,) int32
    each; the label is INT_MAX where no masked reference is within eps."""
    if points_q.device.type == "cpu":
        return ref.pairwise_minlabel_ref(points_q, points_r, labels_r,
                                         mask_r, eps)
    q, r = _points(points_q, points_r, "pairwise_minlabel")
    _check_card(q, "pairwise_minlabel")
    nr = r.shape[0]
    for name, x in (("labels_r", labels_r), ("mask_r", mask_r)):
        if x.device != q.device or tuple(x.shape) != (nr,):
            raise ValueError(f"pairwise_minlabel: {name} must be ({nr},) on "
                             f"{q.device}; got {tuple(x.shape)} on "
                             f"{x.device}")
    lab = labels_r.to(torch.int32).contiguous()
    keep = (mask_r if mask_r.dtype == torch.bool else mask_r != 0).contiguous()
    out_l = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    out_c = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:             # nothing to launch, nothing counted
        return out_l, out_c
    err = _lib().pairwise_minlabel_launch(
        q.data_ptr(), r.data_ptr(), lab.data_ptr(), keep.data_ptr(),
        q.shape[0], nr, q.shape[1], radius2(eps),
        warps_per_query(q.shape[0], nr, q.shape[1]), out_l.data_ptr(),
        out_c.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "pairwise_minlabel")
    pairwise_minlabel.launches += 1
    return out_l, out_c


# Kernel launches (plain integers, read by the on-card smoke run).
pairwise_count.launches = 0
pairwise_minlabel.launches = 0

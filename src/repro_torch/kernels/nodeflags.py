"""The node-flag kernel: each LBVH node's "subtree holds a flagged leaf"
flag in one launch, with no host read.

``csrc/nodeflags.cu`` computes what the level-synchronous loop of
:func:`repro_torch.core.lbvh.propagate_leaf_flags_by_level` computes (the
reference's algorithm, which the port keeps for CPU tensors and as the
oracle of the card tests): a zeroed output, then one thread per flagged
item climbing from its leaf through ``tree.parent`` until it meets a node
already set. Items are leaves, or points mapped onto their leaves by
``item_leaf`` (``Segments.seg_of_point``), which folds in the per-segment
maximum the loop's callers take first.

:func:`repro_torch.core.lbvh.propagate_leaf_flags`, which every caller
goes through (``fdbscan._frontier_node_mask`` with the points' leaves),
launches it for CUDA tensors and runs the loop for CPU tensors. Each
launch adds one to ``node_flag_launches_total`` (a host integer; no device
read).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("nodeflags")
    lib.nodeflags_launch.argtypes = [_I, _I, _P, _P, _P, _P, _P]
    lib.nodeflags_launch.restype = ctypes.c_int
    return lib


def _check(x, name, dtype, shape, dev):
    if x.dtype != dtype:
        raise TypeError(f"node_flags: {name} has dtype {x.dtype}, expected "
                        f"{dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"node_flags: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"node_flags: {name} is not contiguous")
    if x.device != dev:
        raise ValueError(f"node_flags: {name} is on {x.device}, expected "
                         f"{dev}")
    return x.data_ptr()


def node_flags(parent: torch.Tensor, flags: torch.Tensor,
               item_leaf: torch.Tensor | None = None) -> torch.Tensor:
    """(2m-1,) bool: each node's OR of ``flags`` over the items under it.

    ``parent``: (2m-1,) int32, ``lbvh.Tree.parent`` of a tree of m leaves.
    ``flags``: (m,) bool, one a leaf; or, with ``item_leaf`` ((k,) int32,
    each item's leaf), (k,) bool, one an item. Launches on the current
    stream (CUDA tensors only); the output equals
    ``lbvh.propagate_leaf_flags_by_level`` byte for byte.

    Raises TypeError or ValueError for inputs the kernel does not take
    (checked first, so CPU tensors meet the same checks), and ValueError
    for tensors off the card.
    """
    dev = parent.device
    if parent.dim() != 1 or parent.shape[0] % 2 == 0:
        raise ValueError(f"node_flags: parent must be (2m-1,), got shape "
                         f"{tuple(parent.shape)}")
    n_nodes = parent.shape[0]
    k = (n_nodes + 1) // 2 if item_leaf is None else item_leaf.shape[0]
    p = dict(parent=_check(parent, "parent", torch.int32, (n_nodes,), dev),
             flags=_check(flags, "flags", torch.bool, (k,), dev),
             item_leaf=(None if item_leaf is None
                        else _check(item_leaf, "item_leaf", torch.int32,
                                    (k,), dev)))
    if dev.type != "cuda":
        raise ValueError(f"node_flags: the kernel needs CUDA tensors, got "
                         f"{dev}")
    out = torch.empty(n_nodes, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().nodeflags_launch(n_nodes, k, p["parent"], p["flags"],
                                  p["item_leaf"], out.data_ptr(), stream)
    _build.check(err, "node_flags")
    node_flags.launches += 1
    obs_metrics.inc(names.NODE_FLAG_LAUNCHES)
    return out


# Kernel launches (a plain integer, read by the on-card tests).
node_flags.launches = 0

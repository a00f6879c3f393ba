"""Meshes and slab geometry shared by the distributed DBSCAN paths.

Two kinds of helpers live here:

  * the port's meshes, :class:`LocalMesh` and :class:`GroupMesh`, behind
    one small collective interface (one step round the ring, a tiled
    all-gather, a sum of a flag). They take the place of the reference's
    ``shard_map`` programs and their ``lax`` collectives. The reference's
    shims ``vary`` and ``shard_map_compat`` paper over renames in the jax
    API and have no torch counterpart, so the port has none;
  * slab geometry for the sharded tree path (DESIGN.md §6):
    :func:`shard_bounds` fits a shard's resident AABB and :func:`halo_mask`
    is the eps-dilated membership test that decides which traveling
    queries must walk a remote shard's tree at all.

A mesh names its axes and their sizes, as a jax ``Mesh`` does. The
distributed paths split the points over one axis (``"data"``) into
contiguous slabs, one a shard. A process holds some of the shards:

  * :class:`LocalMesh` holds all P shards in one process on one device
    (the counterpart of the reference's forced host devices). Rotation is
    a list rotation, the all-gather a concatenation and the sum a sum.
  * :class:`GroupMesh` holds one shard a rank of a ``torch.distributed``
    process group (SPMD: every rank passes the whole point set, keeps its
    slab and returns the whole result). Rotation is
    ``dist.batch_isend_irecv``. On a ``nccl`` group the collectives move
    CUDA tensors as they are. On any other backend (gloo) they move host
    tensors: a CUDA tensor is copied to the host, sent, and copied back to
    its device, because gloo's send and receive take host tensors only.
    That is how two ranks share the one card of a single-GPU machine,
    where NCCL refuses two ranks on one device; the kernels still run on
    the card.

Every collective a mesh runs is recorded per shard as ``(kind, result
bytes, group size)`` under the reference's HLO names
(``collective-permute``, ``all-gather``, ``all-reduce``) in
``mesh.collectives``, which ``repro_torch.launch.roofline`` turns into
wire bytes.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence

import torch

from repro_torch.core.lbvh import box_dist2
from repro_torch.core.traversal import radius2


def shard_bounds(pts: torch.Tensor, valid: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """AABB (lo, hi) of the *valid* resident points of a shard's slab.

    Padding sentinels (coordinates ~1e30 on the trailing shard) are masked
    out so they cannot stretch the box; a shard with no valid point (tiny
    ``n`` on a wide mesh) reports the unit box — visiting queries may pass
    that halo test, but its tree holds only sentinel primitives, so they
    die at the root box test having evaluated nothing.
    """
    big = torch.tensor(float("inf"), dtype=pts.dtype, device=pts.device)
    keep = valid[:, None]
    lo = torch.where(keep, pts, big).amin(0)
    hi = torch.where(keep, pts, -big).amax(0)
    if bool(valid.any()):
        return lo, hi
    return torch.zeros_like(lo), torch.ones_like(hi)


def halo_mask(q_pts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              eps) -> torch.Tensor:
    """Which of ``q_pts`` lie in the eps-dilated slab of the AABB [lo, hi].

    This is the halo-exchange membership test (DESIGN.md §6): a traveling
    query farther than ``eps`` from a shard's resident bounding box cannot
    be within ``eps`` of any resident point, so its lane is marked inert
    before the local tree walk — it is *not* part of that shard's halo.
    The box distance is the walk's (``lbvh.box_dist2``: one fused
    multiply-add an axis) and ``eps`` is squared in float32, as the
    reference squares it in the points' dtype.
    """
    d2 = box_dist2(q_pts, lo[None, :], hi[None, :])
    return d2 <= radius2(eps)


def _axis_size(mesh, axis: Optional[str]) -> int:
    return dict(zip(mesh.axis_names, mesh.axis_sizes)).get(axis, 1)


def _check_axes(axis_names: Sequence[str], axis_sizes: Sequence[int]):
    names, sizes = tuple(axis_names), tuple(int(s) for s in axis_sizes)
    if len(names) != len(sizes) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} and sizes {sizes} do not match")
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh axis sizes must be >= 1; got {sizes}")
    return names, sizes


class _Mesh:
    """What both meshes share: axis names and sizes, and the record of the
    collectives run (``collectives``: a ``Counter`` of ``(kind, result
    bytes, group size)``, one entry a collective a shard runs)."""

    def __init__(self, axis_names, axis_sizes):
        self.axis_names, self.axis_sizes = _check_axes(axis_names,
                                                       axis_sizes)
        self.collectives: Counter = Counter()

    @property
    def size(self) -> int:
        out = 1
        for s in self.axis_sizes:
            out *= s
        return out

    def _record(self, kind: str, nbytes: int, group: int) -> None:
        self.collectives[(kind, int(nbytes), int(group))] += 1

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                     self.axis_sizes))
        return f"{type(self).__name__}({shape})"


class LocalMesh(_Mesh):
    """P shards in one process on one device.

    The collectives take one entry a shard, in shard order along the axis:
    ``rotate`` moves shard i's block to shard i + 1, ``all_gather``
    concatenates, ``psum`` adds. The other axes (size 1 in the meshes the
    factories make) replicate: the distributed paths compute each data
    shard once.
    """

    def __init__(self, shards: int = 1, axis: str = "data", *,
                 axis_names=None, axis_sizes=None):
        if axis_names is None:
            axis_names, axis_sizes = (axis,), (shards,)
        super().__init__(axis_names, axis_sizes)

    def held(self, axis: str) -> list[int]:
        """The shards along ``axis`` this process holds: all of them."""
        return list(range(_axis_size(self, axis)))

    def rotate(self, axis: str, blocks: list) -> list:
        """One step round the ring: shard i's tuple of tensors moves to
        shard i + 1 (the reference's ``ppermute`` with ``(i, i + 1)``)."""
        p = len(blocks)
        for t in blocks[0]:
            self._record("collective-permute", t.numel() * t.element_size(),
                         p)
        return blocks[-1:] + blocks[:-1]

    def all_gather(self, axis: str, parts: list) -> torch.Tensor:
        """The shards' tensors concatenated in shard order (tiled)."""
        out = torch.cat(parts)
        self._record("all-gather", out.numel() * out.element_size(),
                     len(parts))
        return out

    def psum(self, axis: str, values: list) -> int:
        """The sum over the shards of one flag or count each (ints or 0-d
        tensors, summed as int64 on their device: one host read)."""
        self._record("all-reduce", 8, len(values))
        if all(isinstance(v, torch.Tensor) for v in values):
            return int(torch.stack([v.to(torch.int64)
                                    for v in values]).sum())
        return int(sum(int(v) for v in values))


class GroupMesh(_Mesh):
    """One shard a rank of a ``torch.distributed`` process group.

    Ranks lie on the mesh in row-major order of its axes (as a jax mesh
    lays out its devices), so with axes ``("data", "model")`` of sizes
    ``(D, M)`` rank r is data shard ``r // M``. A ring along an axis joins
    the ranks that share every other coordinate; where the axis spans
    fewer ranks than the group, its subgroups are made on first use, by
    every rank in the same order (SPMD).

    The collectives take one entry, this rank's shard. See the module
    docstring for how tensors move: as they are on ``nccl``, through host
    buffers on gloo.
    """

    def __init__(self, group=None, axis: str = "data", *, axis_names=None,
                 axis_sizes=None):
        import torch.distributed as dist
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("GroupMesh needs an initialised "
                               "torch.distributed process group")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        if axis_names is None:
            axis_names, axis_sizes = (axis,), (self.world,)
        super().__init__(axis_names, axis_sizes)
        if self.size != self.world:
            raise ValueError(f"mesh shape {self.axis_sizes} does not cover "
                             f"the group's {self.world} ranks")
        self._rings: dict = {}

    def _coords(self, rank: int) -> list[int]:
        out = []
        for s in reversed(self.axis_sizes):
            out.append(rank % s)
            rank //= s
        return out[::-1]

    def _ring(self, axis: str):
        """(the ranks of this rank's ring along ``axis`` in shard order, its
        process group, this rank's shard index)."""
        if axis not in self._rings:
            import torch.distributed as dist
            k = self.axis_names.index(axis)
            rings: dict = {}
            for r in range(self.world):
                c = self._coords(r)
                key = tuple(c[:k] + c[k + 1:])
                rings.setdefault(key, []).append(r)
            mine = None
            for members in rings.values():
                if len(rings) == 1:
                    grp = self.group
                else:   # every rank makes every subgroup, in one order
                    glob = [dist.get_global_rank(self.group, r)
                            if self.group is not None else r
                            for r in members]
                    grp = dist.new_group(glob, backend=self.backend)
                if self.rank in members:
                    mine = (members, grp, members.index(self.rank))
            self._rings[axis] = mine
        return self._rings[axis]

    def held(self, axis: str) -> list[int]:
        """The shards along ``axis`` this rank holds: its own."""
        if axis not in self.axis_names:
            return [0]
        return [self._ring(axis)[2]]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the group's backend moves it: bool as uint8, and on
        gloo in host memory."""
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        if self.backend != "nccl" and t.device.type != "cpu":
            return t.cpu()
        return t.contiguous()

    def rotate(self, axis: str, blocks: list) -> list:
        """One step round the ring: this rank's tuple of tensors goes to the
        next shard, the previous shard's comes in."""
        import torch.distributed as dist
        members, grp, me = self._ring(axis)
        p = len(members)
        (block,) = blocks
        for t in block:
            self._record("collective-permute", t.numel() * t.element_size(),
                         p)
        if p == 1:
            return blocks
        nxt = self._global(members[(me + 1) % p])
        prv = self._global(members[(me - 1) % p])
        send = [self._wire(t) for t in block]
        recv = [torch.empty_like(t) for t in send]
        ops = []
        for tag, (s, r) in enumerate(zip(send, recv)):
            ops.append(dist.P2POp(dist.isend, s, nxt, grp, tag))
            ops.append(dist.P2POp(dist.irecv, r, prv, grp, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [tuple(r.to(t.device, t.dtype) for r, t in zip(recv, block))]

    def _global(self, rank: int) -> int:
        import torch.distributed as dist
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    def all_gather(self, axis: str, parts: list) -> torch.Tensor:
        """The ring's tensors concatenated in shard order (tiled)."""
        import torch.distributed as dist
        members, grp, _ = self._ring(axis)
        (part,) = parts
        x = self._wire(part)
        outs = [torch.empty_like(x) for _ in members]
        dist.all_gather(outs, x, group=grp)
        out = torch.cat(outs).to(part.device, part.dtype)
        self._record("all-gather", out.numel() * out.element_size(),
                     len(members))
        return out

    def psum(self, axis: str, values: list) -> int:
        """The sum over the ring of one flag or count a shard (int64)."""
        import torch.distributed as dist
        members, grp, _ = self._ring(axis)
        (v,) = values
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.backend == "nccl" else torch.device("cpu"))
        t = torch.tensor([int(v)], dtype=torch.int64, device=dev)
        dist.all_reduce(t, group=grp)
        self._record("all-reduce", 8, len(members))
        return int(t.item())

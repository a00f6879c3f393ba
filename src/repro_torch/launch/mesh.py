"""Mesh definitions for the distributed path (the port of
``repro.launch.mesh``).

Factory functions only: importing this module touches no device and no
process group. The meshes are ``repro_torch.distributed.sharding``'s:

  * :func:`make_host_mesh` — the mesh a program runs on: one shard a rank
    of the ``torch.distributed`` world where one is initialised, else one
    shard in this process;
  * :func:`make_local_mesh` — P shards in one process on one device (the
    counterpart of the reference's forced host devices);
  * :func:`make_production_mesh` — a descriptor of the reference's
    production shapes laid over H100s. It touches no device: no machine
    here has that many cards.

The sharded DBSCAN path (DESIGN.md §6) shards points over the data axis.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.distributed.sharding import GroupMesh, LocalMesh


class MeshShape(NamedTuple):
    """A mesh's shape without devices: axis names and sizes."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def size(self) -> int:
        out = 1
        for s in self.axis_sizes:
            out *= s
        return out


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production shapes, (data, model) = (16, 16), or
    (pod, data, model) = (2, 16, 16), as a shape over 256 or 512 H100s."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1):
    """A (data, model) mesh over whatever runs this program: the ranks of
    the initialised ``torch.distributed`` world (a ``GroupMesh``), else
    one shard in this process (a ``LocalMesh``)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
        if n % model:
            raise ValueError(f"model={model} does not divide the world's "
                             f"{n} ranks")
        return GroupMesh(axis_names=("data", "model"),
                         axis_sizes=(n // model, model))
    if model != 1:
        raise ValueError("without a process group the host mesh is one "
                         "shard; model must be 1")
    return LocalMesh(axis_names=("data", "model"), axis_sizes=(1, 1))


def make_local_mesh(shards: int, axis: str = "data") -> LocalMesh:
    """``shards`` shards along ``axis`` in this process, on one device."""
    return LocalMesh(shards, axis)


# NVIDIA H100 SXM hardware constants used by the roofline analysis (NVIDIA
# H100 Tensor Core GPU data sheet, SXM part, dense rates without sparsity,
# at the full 700 W power limit).
PEAK_FLOPS_BF16 = 989e12        # per card: bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12         # per card: float32 outside the tensor cores
                                # (the rate the port's kernels run at)
HBM_BW = 3.35e12                # bytes/s per card (HBM3)
# NVLink 4: 900 GB/s per card in both directions together over its 18
# links, so 450e9 bytes/s per direction — the figure here, as the
# reference's ICI_BW is per direction.
NVLINK_BW = 450e9
HBM_PER_CHIP = 80 * 10**9       # 80 GB

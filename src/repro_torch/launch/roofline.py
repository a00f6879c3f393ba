"""Roofline terms (the port of ``repro.launch.roofline``).

compute term    = FLOPs / peak FLOPs          (per card)
memory term     = bytes / HBM bandwidth
collective term = wire bytes / link bandwidth

The reference reads per-partition FLOPs and bytes from XLA's cost
analysis and wire bytes from the post-SPMD HLO text. Torch has no HLO, so
:func:`collective_wire_bytes` takes the record a mesh keeps of the
collectives it ran (``mesh.collectives``: ``(kind, result bytes, group
size)`` a shard, under the HLO names) and applies the reference's per-kind
ring costs to the result buffer size R: all-reduce 2R(g-1)/g, all-gather
R(g-1)/g, reduce-scatter R(g-1), all-to-all R(g-1)/g, collective-permute R.
"""
from __future__ import annotations

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_wire_bytes(records: dict, n_devices: int) -> dict:
    """Per-card wire bytes by collective kind.

    ``records``: a mapping of ``(kind, result bytes, group size)`` to the
    number of such collectives run (a mesh's ``collectives``); a group size
    of None means ``n_devices``."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for (kind, r, g), times in records.items():
        if kind not in out:
            raise ValueError(f"unknown collective kind {kind!r}")
        if r == 0:
            continue
        g = n_devices if g is None else g
        if kind == "all-reduce":
            wire = 2 * r * (g - 1) // max(g, 1)
        elif kind == "all-gather":
            wire = r * (g - 1) // max(g, 1)
        elif kind == "reduce-scatter":
            wire = r * (g - 1)
        elif kind == "all-to-all":
            wire = r * (g - 1) // max(g, 1)
        else:  # collective-permute
            wire = r
        out[kind] += wire * times
        counts[kind] += times
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = counts
    return out


def roofline_terms(cost: dict, wire: dict, *, peak_flops: float,
                   hbm_bw: float, ici_bw: float) -> dict:
    """The three terms, the dominant one and the bound (the largest).

    ``cost``: ``{"flops": ..., "bytes accessed": ...}``; ``wire``: from
    :func:`collective_wire_bytes`; ``ici_bw``: the link bandwidth (the
    reference's name; ``launch.mesh.NVLINK_BW`` on the H100)."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / peak_flops
    t_memory = bytes_accessed / hbm_bw
    t_collective = wire["total"] / ici_bw
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)), key=lambda kv: kv[1])[0]
    return {
        "hlo_flops": flops,
        "hlo_bytes": bytes_accessed,
        "wire_bytes": wire["total"],
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "bound_time_s": max(t_compute, t_memory, t_collective),
    }

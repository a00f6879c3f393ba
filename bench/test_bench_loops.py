"""Each mix at a tiny size on the CPU, through the harness: the program's
answers come out correct, and a traced run reads the per-layer metrics
that the CPU has (spans and counters; the device trace needs the card)."""
import time
from pathlib import Path

import pytest
import torch

from bench import harness

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
pytest.importorskip("repro_torch")


def scaled_eps(cfg: dict, n: int) -> float:
    """The configuration's eps at ``n`` points: the same number of mean
    point spacings."""
    return cfg["eps"] * (cfg["n"] / n) ** (1 / cfg["d"])


def tiny(workload: str) -> harness.Cell:
    """The cell at a size the CPU's plain walks finish in seconds, eps
    scaled to keep the configuration's neighbourhood size."""
    cell = harness.load_cell(ROOT, workload)
    cfg, mix = dict(cell.cfg), dict(cell.mix)
    if mix["loop"] == "stream":
        n = 128
        cfg["min_pts"] = 5
        mix.update(batch=16, probes_checked_per_step=8, checkpoint_every=2,
                   period=2)
    else:
        n = 1100                    # above the tiled path's 1,024
        cfg["min_pts_sweep"] = cfg["min_pts_sweep"][:2]
        mix["period"] = 1 if mix["loop"] == "fresh" else 2
    cfg["eps"] = scaled_eps(cfg, n)
    cfg["n"] = n
    mix["profile_units"] = 1
    if "memory_units" in mix:
        mix["memory_units"] = 2
    return cell._replace(cfg=cfg, mix=mix)


def run(cell, trace=False, seconds=0.01, seed=2 ** 31 + 17):
    log = []
    res, limits = harness.run(cell, seed, seconds, trace, "cpu",
                              time.perf_counter(), log.append)
    return res, limits, log


@pytest.mark.parametrize("workload", ["hacc.fresh", "porto.minpts_sweep",
                                      "porto.stream"])
def test_a_run_is_correct(workload):
    res, limits, log = run(tiny(workload))
    assert res["correct"], (limits, log)
    assert res["failed"] == 0 and res["attempted"] >= 1
    names = {m["name"] for m in tiny(workload).end_to_end}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for k, v in res["metrics"].items()
               if k != "peak_device_mb")
    assert list(res)[-1] == "checks"


def test_the_window_runs_at_least_memory_units():
    cell = tiny("hacc.fresh")
    cell = cell._replace(mix=dict(cell.mix, memory_units=3))
    res, limits, log = run(cell)
    assert res["correct"], (limits, log)
    assert res["attempted"] >= 3


@pytest.mark.parametrize("workload,expect", [
    ("hacc.fresh", {"plan_host_ms.fresh", "build_ms.fresh"}),
    ("porto.minpts_sweep", {"plan_host_ms.resident", "sweeps_ms.resident",
                            "n_sweeps.resident"}),
])
def test_a_traced_run_reads_spans_and_counters(workload, expect):
    res, limits, log = run(tiny(workload), trace=True)
    assert res["correct"], (limits, log)
    assert expect <= set(res["metrics"])
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_fresh_draw_check_judges_the_program_on_a_new_set():
    from bench import control
    cell = tiny("porto.minpts_sweep")
    got = control.fresh_draw(cell, 2 ** 31 + 23, "cpu")
    assert harness.passes(harness.limits_of(got)), got
    assert got["calls_checked"] == len(cell.cfg["min_pts_sweep"])

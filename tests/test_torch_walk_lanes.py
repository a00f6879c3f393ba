"""``tools/walk_lanes.py``: its per-lane sums on hand-made walks, and its
view of a clustering call agreeing with the program's own counters."""
import importlib.util
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import dispatch, fdbscan  # noqa: E402
from repro_torch.obs import names  # noqa: E402

_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "walk_lanes.py")
_spec = importlib.util.spec_from_file_location("walk_lanes", _PATH)
walk_lanes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(walk_lanes)


class _Walk(NamedTuple):
    evals: torch.Tensor
    iters: torch.Tensor


class _Segs(NamedTuple):
    dense_pt: torch.Tensor


def test_sums_on_hand_made_walks():
    # 40 lanes: lane 0 is long (2,000 tests, 500 trips), the others test
    # 10 members in 4 trips; lanes 0 to 9 lie in dense cells
    ev = torch.full((40,), 10, dtype=torch.int32)
    it = torch.full((40,), 4, dtype=torch.int32)
    ev[0], it[0] = 2000, 500
    dense = torch.arange(40) < 10
    lanes = walk_lanes.Lanes(threads=8)
    lanes.add(_Walk(ev, it), _Segs(dense), None)
    # an empty walk counts as a walk and adds nothing else
    empty = torch.zeros(0, dtype=torch.int32)
    lanes.add(_Walk(empty, empty), _Segs(dense), torch.zeros(0))
    got = lanes.summary()
    assert got["walks"] == 2 and got["lanes"] == 40
    assert got["evals"] == 2000 + 39 * 10
    assert got["loose_evals_share"] == pytest.approx(300 / 2390)
    assert got["lane_evals_max"] == 2000 and got["lane_iters_max"] == 500
    assert got["evals_share_long"] == pytest.approx(2000 / 2390)
    # two runs of 32 lanes: the first's longest is 500 trips, the second
    # (8 lanes, padded with idle threads) 4
    trips = 500 + 39 * 4
    assert got["warp32_share"] == pytest.approx(trips / (32 * 500 + 32 * 4))
    # 8 threads would take trips / 8 = 82 trips balanced; lane 0 takes 500
    assert got["tail_trips"] == pytest.approx(500 - trips / 8)


def test_lanes_of_a_call_match_the_programs_counters(monkeypatch):
    # restored after the test: watch() wraps the module's function
    monkeypatch.setattr(fdbscan, "_record_trace", fdbscan._record_trace)
    rng = np.random.default_rng(7)
    blobs = rng.normal(0, 0.01, size=(2, 250, 2)) + rng.uniform(
        0.2, 0.8, size=(2, 1, 2))
    pts = np.concatenate([blobs.reshape(-1, 2), rng.uniform(
        0, 1, size=(200, 2))]).astype(np.float32)
    take = walk_lanes.watch(threads=1)
    dispatch.clear_cache()
    try:
        with obs.instrumented() as (reg, _):
            res = repro_torch.dbscan(pts, 0.05, 5,
                                     algorithm="fdbscan-densebox",
                                     device="cpu")
            snap = reg.snapshot()
    finally:
        dispatch.clear_cache()
    got = take().summary()

    def total(name):
        fam = [m for m in snap["metrics"] if m["name"] == name]
        return sum(s["value"] for s in fam[0]["series"])

    # every walk of the call: the first pass, the sweeps, the border
    assert got["walks"] == res.n_traversals
    assert got["evals"] == total("traversal_evals_total")
    assert got["loose_evals_share"] * got["evals"] == pytest.approx(
        total(names.TRAVERSAL_LOOSE_EVALS))
    assert 0 < got["loose_evals_share"] < 1
    assert got["tail_trips"] == 0.0   # one thread: every walk balanced

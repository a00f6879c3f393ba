"""The port's tuner (``repro_torch.core.tune``) against the reference's
(``repro.core.tune``), on the CPU: the same decisions for the same points
(``stats["tuned_config"]`` before and after a run, ``_index_bytes``,
``stats_key``), the reference's unit cases (mode parsing, the budget cap,
phase fallbacks, the pin, ``engine_fn`` identities, the search cache), the
tuned run's per-sweep work counters (under the heuristic) and its metrics
against the reference's ``pallas-tree`` run. The (lane tile, unroll) grid
is in ``test_torch_tune_grid.py``.

Tolerance: zero. Labels, core masks, cluster and sweep counts are
byte-equal under every config; ``iters`` are compared at equal unroll.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

from repro.core import dispatch as jdispatch  # noqa: E402
from repro.core import fdbscan as jfdbscan  # noqa: E402
from repro.core import tune as jtune  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core import dispatch, fdbscan, grid, lbvh  # noqa: E402
from repro_torch.core import traversal, tune  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.kernels import traverse as kt  # noqa: E402
from repro_torch.obs import names as obs_names  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = np.load(os.path.join(HERE, "golden", "golden.npz"))
CPU = torch.device("cpu")

# the portotaxi golden scenario (tests/golden/make_golden.py), as the
# reference's tests/test_tune.py uses it
DSET, N, EPS, MINPTS = "portotaxi_like", 800, 0.02, 5


@pytest.fixture(scope="module")
def pts():
    return pointclouds.load(DSET, N)


@pytest.fixture(scope="module")
def index(pts):
    segs = grid.build_segments_fdbscan(torch.from_numpy(pts))
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    return segs, tree


@pytest.fixture(autouse=True)
def _fresh_caches():
    dispatch.clear_cache()
    jdispatch.clear_cache()
    yield
    dispatch.clear_cache()
    jdispatch.clear_cache()


def _assert_golden(res):
    g = f"{DSET}/fdbscan"
    np.testing.assert_array_equal(res.labels.numpy(), GOLDEN[f"{g}/labels"])
    np.testing.assert_array_equal(res.core_mask.numpy(), GOLDEN[f"{g}/core"])
    assert res.n_clusters == int(GOLDEN[f"{g}/n_clusters"])
    assert res.n_sweeps == int(GOLDEN[f"{g}/n_sweeps"])


@pytest.mark.parametrize("mode", ["off", "heuristic"])
def test_tuned_config_matches_reference(pts, mode, monkeypatch):
    # the plan's recorded decision, and the state's description after two
    # runs (the depth oracle calibrated under the heuristic; the pin never
    # calibrates, so the reference's description stays its plan's). Under
    # the heuristic each run's per-sweep frontier sizes, lanes, trips and
    # evaluations (its engines, lane orders and small-frontier fallbacks)
    # equal the reference's pallas-tree run's, the uncalibrated first and
    # the calibrated second
    monkeypatch.setenv("REPRO_TUNE", mode)
    jp = jdispatch.plan(pts, EPS, MINPTS, algorithm="pallas-tree")
    p = dispatch.plan(pts, EPS, MINPTS, algorithm="pallas-tree", device=CPU)
    assert p.stats["tuned_config"] == jp.stats["tuned_config"]
    assert p.tune.config == tuple(jp.tune.config)
    for _ in range(2):
        res, stats = fdbscan.cluster_from_index(
            p.segs, p.tree, EPS, MINPTS, backend="pallas-tree",
            with_stats=True, tune=p.tune)
        _assert_golden(res)
        if mode == "heuristic":
            _, ref_stats = jfdbscan.cluster_from_index(
                jp.segs, jp.tree, EPS, MINPTS, backend="pallas-tree",
                with_stats=True, tune=jp.tune)
            assert stats == ref_stats
    assert p.tune.describe() == jp.tune.describe()
    assert p.tune.describe()["calibrated"] == (mode == "heuristic")


def test_index_bytes_and_stats_key_match_reference(pts, index):
    # the reference's field set at its dtypes: the port's int64 Morton
    # codes count 4 bytes each, so the same points give the same bytes
    jp = jdispatch.plan(pts, EPS, MINPTS, algorithm="fdbscan")
    segs, tree = index
    assert tune._index_bytes(segs, tree) == jtune._index_bytes(
        jp.segs, jp.tree)
    assert tune.lane_tiles_within_budget(tune._index_bytes(segs, tree)) \
        == jtune.lane_tiles_within_budget(jtune._index_bytes(jp.segs,
                                                             jp.tree))
    for eps, mp in ((EPS, MINPTS), (0.0, MINPTS), (0.05, 8)):
        assert tune.stats_key(segs, eps, mp) == jtune.stats_key(jp.segs, eps,
                                                                mp)
    assert tune.heuristic(segs, tree) == tuple(jtune.heuristic(jp.segs,
                                                               jp.tree))


def test_tuned_metrics_match_reference(pts, monkeypatch):
    # an instrumented pallas-tree run: the tuned_config_info gauge and the
    # walks' counters under the reference's engine labels ("pallas" for a
    # tuned phase's kernel engine, "reference" for the fallback)
    monkeypatch.setenv("REPRO_TUNE", "heuristic")
    jreg = jmetrics.install(jmetrics.Registry())
    try:
        import repro
        repro.dbscan(pts, EPS, MINPTS, algorithm="pallas-tree")
    finally:
        jmetrics.uninstall()
    with obs.instrumented() as (reg, _):
        dispatch.dbscan(pts, EPS, MINPTS, algorithm="pallas-tree",
                        device=CPU)
    doc, jdoc = reg.snapshot(), jreg.snapshot()
    # the reference also counts its Pallas kernel's launches on the CPU
    # (interpret mode), but only outside its jitted first pass; the port's
    # CPU walks launch no kernel, and its launch counters count the walk
    # kernel's launches on the card (chip_smoke.py holds those)
    jdoc["metrics"] = [m for m in jdoc["metrics"]
                       if not m["name"].startswith("pallas_kernel_")]
    # the port's own counters (its host syncs) have no reference twin
    doc["metrics"] = [m for m in doc["metrics"]
                      if m["name"] not in obs_names.PORT_COUNTERS]
    assert doc == jdoc
    engines = {s["labels"]["engine"] for m in doc["metrics"]
               if m["name"].startswith("traversal_") for s in m["series"]}
    assert engines == {"pallas", "reference"}
    assert "tuned_config_info" in {m["name"] for m in doc["metrics"]}


# --------------------------------------------------------------------- #
# the reference's unit cases                                            #
# --------------------------------------------------------------------- #

def test_off_pin_is_todays_kernel_identity():
    assert tune.PINNED.first_pass == tune.PhaseConfig("pallas", 128, 4,
                                                      "none")
    assert tune.engine_fn(tune.PhaseConfig()) is kt.traverse
    assert tune.engine_fn(tune.PhaseConfig("reference")) \
        is traversal.traverse
    cfg = tune.PhaseConfig("pallas", 256, 1, "depth")
    assert tune.engine_fn(cfg) is tune.engine_fn(cfg)
    assert tune.engine_fn(cfg).keywords == dict(lane_tile=256, unroll=1,
                                                reorder="depth")


def test_mode_parsing(monkeypatch):
    for raw, want in [("off", "off"), ("0", "off"), ("none", "off"),
                      ("pinned", "off"), ("OFF", "off"),
                      ("search", "search"), ("heuristic", "heuristic"),
                      ("banana", "heuristic")]:
        monkeypatch.setenv("REPRO_TUNE", raw)
        assert tune.mode() == want == jtune.mode()
    monkeypatch.delenv("REPRO_TUNE", raising=False)
    assert tune.mode() == "heuristic"


def test_stats_key_buckets(index):
    segs, _ = index
    k1 = tune.stats_key(segs, EPS, MINPTS)
    assert k1 == tune.stats_key(segs, EPS, MINPTS)
    assert all(isinstance(v, int) for v in k1)
    assert k1 != tune.stats_key(segs, EPS, MINPTS + 1)
    small = grid.build_segments_fdbscan(
        torch.from_numpy(pointclouds.load(DSET, 100)))
    assert tune.stats_key(small, EPS, MINPTS) != k1


def test_lane_tiles_within_budget():
    assert tune.lane_tiles_within_budget(0) == tune.TUNE_LANE_TILES
    assert tune.lane_tiles_within_budget(
        tune.VMEM_BUDGET_BYTES * 2) == tune.TUNE_LANE_TILES[:1]
    for b in (0, 87_964, tune.VMEM_BUDGET_BYTES - 64 * 300):
        assert tune.lane_tiles_within_budget(b) \
            == jtune.lane_tiles_within_budget(b)


def test_phase_fallbacks():
    st = tune.TuneState(tune.TunedConfig(
        first_pass=tune.PhaseConfig("pallas", 256, 1, "depth"),
        sweep=tune.PhaseConfig("pallas", 256, 1, "depth"),
        border=tune.PhaseConfig("auto", 256, 1, "none"),
        min_lanes=256, border_min_frac=0.9, source="heuristic"))
    assert st.phase("sweep", n_lanes=64).engine == "reference"
    assert st.phase("sweep", n_lanes=512).engine == "pallas"
    assert st.phase("border", n_lanes=100, n=1000).engine == "reference"
    assert st.phase("border", n_lanes=950, n=1000).engine == "pallas"
    assert st.rank_for(st.phase("sweep", n_lanes=512)) is None
    st.calibrate(torch.arange(4))
    assert st.rank_for(st.phase("sweep", n_lanes=512)) is not None
    assert st.rank_for(st.phase("border", n_lanes=950, n=1000)) is None
    d = st.describe()
    assert d["source"] == "heuristic" and d["calibrated"]
    assert d["sweep"]["lane_tile"] == 256


def test_pinned_never_calibrates():
    st = tune.TuneState(tune.PINNED)
    st.calibrate(torch.arange(4))
    assert st.depth_rank is None


def test_auto_on_the_cpu_attaches_nothing(pts):
    p = dispatch.plan(pts, EPS, MINPTS, algorithm="fdbscan-densebox",
                      device=CPU)
    assert p.tune is None and "tuned_config" not in p.stats
    big = pointclouds.load(DSET, 1200)
    p = dispatch.plan(big, EPS, MINPTS, device=CPU)
    assert p.backend != "pallas-tree" and p.tune is None


def test_search_mode_cached_and_bit_identical(monkeypatch):
    monkeypatch.setenv("REPRO_TUNE", "search")
    calls = []
    orig = tune.search

    def counting_search(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tune, "search", counting_search)
    pts = pointclouds.load("blobs", 300)
    ref = dispatch.dbscan(pts, 0.05, 8, algorithm="fdbscan", device=CPU)
    with obs.instrumented() as (reg, tracer):
        p = dispatch.plan(pts, 0.05, 8, algorithm="pallas-tree", device=CPU)
        # a permuted copy of the same point set has identical index stats:
        # the plan is new, but the search result is reused
        p2 = dispatch.plan(pts[::-1].copy(), 0.05, 8,
                           algorithm="pallas-tree", device=CPU)
    assert p.tune.config.source == "search"
    assert "timings" in p.tune.info and "mean_hits" in p.tune.info
    assert set(p.tune.info["timings"]) == {"first_pass", "sweep", "border"}
    assert p2.tune.config == p.tune.config
    assert len(calls) == 1
    assert reg.get("tune_searches_total").value == 1.0
    assert [e["name"] for e in tracer.events].count("tune.search") == 1
    res = dispatch.dbscan(pts, 0.05, 8, query_plan=p)
    np.testing.assert_array_equal(res.labels.numpy(), ref.labels.numpy())
    np.testing.assert_array_equal(res.core_mask.numpy(),
                                  ref.core_mask.numpy())
    assert (res.n_clusters, res.n_sweeps) == (ref.n_clusters, ref.n_sweeps)

"""The port's clustering CLI (``python -m repro_torch.launch.cluster``)
against the reference's (``repro.launch.cluster``) on the CPU, and the
port's baselines (``core.baselines``) against the reference's.

Every algorithm the CLI takes on a tree-free or tree path writes ``--out``
labels byte-equal to the reference CLI's on the same arguments; its
``--metrics-json`` and ``--trace`` files pass both packages' validators; a
``pallas-tree`` run prints and returns the plan's tuner decision; ``ring``
raises, naming the ROADMAP item that brings it; and without a CUDA device
the CLI refuses to run unless given ``--device cpu``. ``gdbscan`` and
``dbscan_bruteforce_np`` equal the reference's on boundary-separated
points.

Tolerance: zero (labels byte-equal).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

from repro.core import baselines as jbaselines  # noqa: E402
from repro.launch import cluster as jcli  # noqa: E402
from repro.obs import metrics as jmetrics, trace as jtrace  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import baselines, dispatch  # noqa: E402
from repro_torch.launch import cluster as cli  # noqa: E402
from repro_torch.obs import validate as obs_validate  # noqa: E402

from conftest import separated_points  # noqa: E402

# blobs at n = 600: auto takes the tiles (n <= 1024), the tree backends
# walk an index with dense cells
ARGS = ["--data", "blobs", "-n", "600", "--eps", "0.05", "--minpts", "8"]
ALGORITHMS = ["auto", "fdbscan", "fdbscan-densebox", "tiled", "pallas-tree",
              "gdbscan"]


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_labels_equal_reference_cli(tmp_path, algorithm):
    dispatch.clear_cache()
    ref, port = tmp_path / "ref.npy", tmp_path / "port.npy"
    jcli.main(ARGS + ["--algorithm", algorithm, "--out", str(ref)])
    out = cli.main(ARGS + ["--algorithm", algorithm, "--out", str(port),
                           "--device", "cpu"])
    want, got = np.load(ref), np.load(port)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert out["n_clusters"] == len(np.unique(want[want >= 0]))
    assert (out["tuned_config"] is not None) == (algorithm == "pallas-tree")


def test_metrics_and_trace_pass_both_validators(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setenv("REPRO_TUNE", "heuristic")
    dispatch.clear_cache()
    m, t = tmp_path / "m.json", tmp_path / "t.json"
    out = cli.main(ARGS + ["--algorithm", "pallas-tree", "--device", "cpu",
                           "--metrics-json", str(m), "--trace", str(t)])
    printed = capsys.readouterr().out
    assert "tuned_config" in printed
    assert out["tuned_config"]["source"] == "heuristic"
    assert out["tuned_config"]["calibrated"] is False   # as planned
    assert obs_validate.main(["--metrics", str(m), "--trace", str(t),
                              "--require-span", "sweep",
                              "--require-metric", "tuned_config_info"]) == 0
    doc, tdoc = json.loads(m.read_text()), json.loads(t.read_text())
    jmetrics.validate_snapshot(doc)
    jtrace.validate_chrome_trace(tdoc)
    names = {e["name"] for e in tdoc["traceEvents"]}
    assert {"plan", "dbscan", "traverse", "sweep", "border",
            "finalize"} <= names
    # the gauge carries the per-phase decision, as the reference's does
    gauge = next(f for f in doc["metrics"] if f["name"] == "tuned_config_info")
    assert {s["labels"]["phase"] for s in gauge["series"]} == {
        "first_pass", "sweep", "border"}


def test_ring_raises_and_no_cuda_refuses(monkeypatch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        cli.main(ARGS + ["--algorithm", "ring", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ei:
        cli.main(ARGS)
    assert ei.value.code == 2
    assert cli.main(ARGS + ["--device", "cpu"])["n_clusters"] > 0


@pytest.mark.parametrize("d", [2, 3])
def test_baselines_match_reference(d):
    # boundary-separated points: no pair within 0.2% of eps^2 of the
    # boundary, so the brute forms cannot round a pair differently
    eps, mp = 0.06, 5
    pts = separated_points(600, d, eps=eps, seed=d)
    want = jbaselines.gdbscan(pts, eps, mp)
    got = baselines.gdbscan(pts, eps, mp, device="cpu")
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.core_mask.numpy(),
                                  np.asarray(want.core_mask))
    assert (got.n_clusters, got.n_sweeps) == (want.n_clusters, want.n_sweeps)
    assert got.labels.dtype == torch.int32
    wl, wc = jbaselines.dbscan_bruteforce_np(pts, eps, mp)
    gl, gc = repro_torch.core.dbscan_bruteforce_np(pts, eps, mp)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gc, wc)
    # and both agree with the tree backend on the core partition
    res = repro_torch.dbscan(pts, eps, mp, algorithm="fdbscan", device="cpu")
    np.testing.assert_array_equal(res.core_mask.numpy(), gc)
    assert res.n_clusters == got.n_clusters

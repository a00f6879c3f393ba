"""The harness finds every cell's configuration, mix and metric readers by
name; ``BENCHMARK.json`` keeps to its contract; the command refuses to run
without a card or without the program; the arithmetic of the roofline and
of the trace readers, on hand-made numbers (CPU)."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import data, harness, loops, roofline, tracemath

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _workloads():
    return [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", _workloads())
def test_every_cell_is_found_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    loop = loops.load(cell.mix["loop"])
    assert all(callable(getattr(loop, f)) for f in
               ("setup", "unit", "checks", "free", "work_of"))
    gen = data.find("generators", cell.cfg["generator"]["name"])
    assert callable(gen.catalog) and callable(gen.draw)
    assert cell.mix["rate_metric"] in {m["name"] for m in cell.end_to_end}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in names
    for key in ("n", "d", "eps", "min_pts", "min_pts_sweep", "guarantee",
                "generator", "reduced", "assumed", "source"):
        assert key in cell.cfg, key


def _files(folder):
    return sorted(p.stem for p in (ROOT / "bench" / folder).glob("*.py")
                  if p.stem != "__init__")


@pytest.mark.parametrize("kind", _files("loops"))
def test_every_loop_file_is_found_by_its_name(kind):
    loop = loops.load(kind)
    assert loop.__module__ == f"bench.loops.{kind}"
    assert issubclass(loop, loops.BaseLoop)


@pytest.mark.parametrize("name", _files("generators"))
def test_every_generator_file_is_found_by_its_name(name):
    gen = data.find("generators", name)
    assert gen.__name__ == f"bench.generators.{name}"
    assert callable(gen.catalog) and callable(gen.draw)


@pytest.mark.parametrize("folder", ["loops", "generators"])
def test_a_name_that_is_no_file_is_refused(folder):
    with pytest.raises(ModuleNotFoundError):
        data.find(folder, "no_such_file")
    with pytest.raises(ValueError):
        data.find(folder, "../run")


def test_benchmark_json_keeps_to_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert (ROOT / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    used = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
    assert {c["name"] for c in SPEC["configs"]} == {c for c, _ in used}
    names = set()
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.add(m["name"])
    assert "setup_s" in names
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in names and m["name"] not in names
        names.add(m["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(names) == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "bench.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


ARGS = ["--workload", "hacc.fresh", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0"]


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without")
    out = _run(ARGS, ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(ARGS, tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_roofline_terms_on_hand_numbers():
    t = roofline.terms(67e12, 3.35e12 / 2)
    assert t["t_ops_s"] == pytest.approx(1.0)
    assert t["t_bytes_s"] == pytest.approx(0.5)
    assert t["bound_s"] == pytest.approx(1.0) and t["by"] == "operations"
    t = roofline.terms(0.0, 3.35e9)
    assert t["bound_s"] == pytest.approx(1e-3) and t["by"] == "bytes"
    assert roofline.share(1e-3, 4e-3) == pytest.approx(25.0)
    assert roofline.share(1e-3, 0.0) is None
    counts = torch.tensor([5, 5, 1, 3, 5])
    dense = torch.tensor([True, False, False, False, False])
    ops, nbytes = roofline.clustering_work(5, 3, counts, dense)
    assert ops == 9 * (4 + 0 + 2 + 4) and nbytes == 5 * 12 + 5 * 4 + 5


def _ev(name, ts, dur, cat="kernel"):
    return {"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": dur}


def test_span_and_trace_arithmetic_on_hand_made_events():
    spans = [_ev("plan", 0, 100, "repro"), _ev("build", 10, 30, "repro"),
             _ev("build", 60, 20, "repro"), _ev("sweep", 200, 50, "repro"),
             _ev("sweep", 220, 10, "repro")]
    assert tracemath.span_seconds(spans, "sweep") == pytest.approx(50e-6)
    assert tracemath.self_seconds(spans, "plan", "build") == \
        pytest.approx(50e-6)
    assert tracemath.union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    doc = {"traceEvents": [
        _ev("walk_kernel<3>", 0, 10), _ev("walk_kernel<3>", 40, 10),
        _ev("vectorized_elementwise", 5, 10), _ev("Memcpy DtoH", 70, 5,
                                                  "gpu_memcpy"),
        _ev("aten::nonzero", 14, 30, "cpu_op"),
        _ev("cudaStreamSynchronize", 20, 20, "cuda_runtime"),
        _ev("aten::add", 50, 25, "cpu_op")]}
    dt = tracemath.DeviceTrace(doc)
    assert dt.busy_s() == pytest.approx(30e-6)
    assert dt.kernel_seconds("walk_kernel") == (2, pytest.approx(20e-6))
    assert dt.top_ops(2) == [["walk_kernel<3>", pytest.approx(20e-6)],
                             ["vectorized_elementwise", pytest.approx(10e-6)]]
    gaps = dict(dt.idle_gaps(0, 80e-6))
    # 15..40: the sync is the innermost op at the midpoint; 50..70:
    # aten::add; 75..80: nothing recorded
    assert gaps["cudaStreamSynchronize"] == pytest.approx(25e-6)
    assert gaps["aten::add"] == pytest.approx(20e-6)
    assert gaps["host Python, no torch operation"] == pytest.approx(5e-6)
    launches = {"metrics": [{"name": "pallas_kernel_launches_total",
                             "series": [{"labels": {}, "value": 2.0}]}]}
    ctx = harness.Readings(spans=[], counters={}, traced_units=1, device=dt,
                           profiled_units=2, profiled_s=80e-6,
                           launches=launches, work=None)
    assert tracemath.walk_launches(ctx) == (2, pytest.approx(20e-6))
    assert tracemath.idle_share(ctx) == pytest.approx(100 * (1 - 30 / 80))
    assert harness.reader("walk_device_ms.resident")(ctx) == \
        pytest.approx(0.01)
    lost = ctx._replace(launches={"metrics": [
        {"name": "pallas_kernel_launches_total",
         "series": [{"labels": {}, "value": 3.0}]}]})
    assert harness.reader("walk_device_ms.resident")(lost) is None
    snap = {"metrics": [{"name": "dbscan_sweeps", "series": [
        {"labels": {"backend": "a"}, "count": 2, "sum": 9.0}]}]}
    assert tracemath.counter_total(snap, "dbscan_sweeps") == 9.0
    assert tracemath.counter_total(snap, "absent") is None

"""One run of one cell: set-up, the measured window, the checks, the
result.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
the configuration and the mix of each cell; the configuration's file is
the one ``configs`` gives, and its generator ``bench/generators/<name>.py``;
the mix is ``bench/mixes/<traffic>.json``, and the loop that runs it
``bench/loops/<loop>.py``; each per-layer metric ``<name>`` is read by
``bench/metrics/<name>.py``. Adding a cell, a kind of traffic, a generator
or a metric adds files and entries, and edits none.

With ``trace`` off the window runs the program alone and gives the cell's
end-to-end metrics. It closes after the first unit (call or step) that
ends past ``seconds`` with a whole number of the mix's ``period`` of units
done, so every window holds whole cycles of the mix's work. Where the mix
gives ``memory_units``, the window's memory peak is read when that many
units are done (the window runs at least that many), so a state that
grows with every step is read at a fixed step count. With ``trace`` on, the window's first units run under
``torch.profiler`` (with the program's counters on, for the launch count
the device trace is held to); once the device trace is read, further
units run for the rest of ``seconds`` under the program's spans and
counters (``repro_torch.obs``, spans synchronised at close). The
per-layer metrics are read from those.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import torch

from . import loops, tracemath

BENCH = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    cfg: dict
    mix: dict
    end_to_end: list
    per_layer: list


def _for(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str, spec: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (or of ``spec``)."""
    if spec is None:
        spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(workload, int(w["chips"]), cfg, mix,
                [m for m in spec["end_to_end"] if _for(m, workload)],
                [m for m in spec["per_layer"] if _for(m, workload)])


def reader(name: str):
    """The ``read(ctx)`` function of per-layer metric ``name``."""
    path = BENCH / "metrics" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


class Readings(NamedTuple):
    """What a per-layer reader reads (``bench/metrics/*.py``)."""
    spans: list            # the program's span events, traced stretch
    counters: dict         # the program's counters, traced stretch
    traced_units: int      # units in the traced stretch
    device: object         # tracemath.DeviceTrace of the profiled stretch
    profiled_units: int    # units in the profiled stretch
    profiled_s: float      # host-clock length of the profiled stretch
    launches: dict         # counters of the profiled stretch
    work: list             # (operations, bytes) per profiled unit, or None


def limits_of(checks: dict) -> dict:
    """Each compared number with its limit: violation counts at most 0,
    the number of answers judged at least 1."""
    out = {}
    for k, v in checks.items():
        if k.endswith("_checked"):
            out[k] = {"value": v, "min": 1}
        else:
            out[k] = {"value": v, "max": 0}
    return out


def passes(limits: dict) -> bool:
    for c in limits.values():
        v = c["value"]
        if v is None:
            return False
        if "max" in c and v > c["max"]:
            return False
        if "min" in c and v < c["min"]:
            return False
    return True


def _units(loop, n: int, done: list, failed: list, log,
           times: list | None = None) -> None:
    """Run ``n`` window units (``done`` counts them; ``times`` gathers
    their host-clock seconds)."""
    for _ in range(n):
        t = time.perf_counter()
        try:
            loop.unit(done[0])
        except Exception:           # counted; the checks judge the rest
            failed[0] += 1
            log("unit %d failed:\n%s" % (done[0], traceback.format_exc()))
        if times is not None:
            times.append(time.perf_counter() - t)
        done[0] += 1


def _unit_spread(times: list, period: int) -> str:
    """Each place in the period: its units' min, median and max in ms."""
    out = []
    for p in range(period):
        ts = sorted(times[p::period])
        if ts:
            out.append(f"{p}: {ts[0] * 1e3:.1f}/{ts[len(ts) // 2] * 1e3:.1f}"
                       f"/{ts[-1] * 1e3:.1f}")
    return "; ".join(out)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log, tmpdir: str | None = None) -> tuple:
    """Run ``cell`` once. Returns ``(result, limits)``: the result line's
    object and the compared numbers with their limits."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tmpdir = tmpdir or tempfile.gettempdir()
    loop = loops.load(cell.mix["loop"])(cell.cfg, cell.mix, seed, dev,
                                        tmpdir, log)
    loop.setup()
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f} (data drawn in {loop.gen_s:.3f} s)")
    loop.gen_s = 0.0
    done, failed = [0], [0]
    readings = None
    period = int(cell.mix.get("period", 1))
    mem_units = int(cell.mix.get("memory_units", 0))
    mem_at = None
    times: list = []
    t0 = time.perf_counter()
    if not trace:
        while True:
            _units(loop, 1, done, failed, log, times)
            if cuda and done[0] == mem_units:
                mem_at = torch.cuda.max_memory_allocated(dev)
            if (time.perf_counter() - t0 >= seconds
                    and done[0] % period == 0 and done[0] >= mem_units):
                break
        log(f"unit ms (min/median/max) by place in the period: "
            f"{_unit_spread(times, period)}")
    else:
        readings = _traced_window(loop, cell, seconds, done, failed, dev,
                                  tmpdir, log)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    mem_peak = max(setup_peak, peak) if cuda else 0
    log(f"window {window_s:.3f} s, {done[0]} units, {failed[0]} failed; "
        f"data drawn in the window {loop.gen_s:.3f} s; "
        f"peak {peak / 1e6:.1f} MB"
        + (f", {mem_at / 1e6:.1f} MB after {mem_units} units"
           if mem_at is not None else ""))
    if mem_at is not None:
        peak = mem_at
    t_check = time.perf_counter()
    checks = loop.checks()
    limits = limits_of(checks)
    log(f"checks took {time.perf_counter() - t_check:.3f} s")
    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, "peak_device_mb": peak / 1e6,
                  cell.mix["rate_metric"]: window_s * 1e3 / done[0]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = readings._replace(work=[loop.work_of(i) for i in
                                      range(readings.profiled_units)])
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    loop.free()
    loop = None
    gc.collect()
    result = {
        "correct": failed[0] == 0 and passes(limits),
        "attempted": done[0],
        "failed": failed[0],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": int(mem_peak)},
    }
    if trace:
        dt = readings.device
        result["device"]["busy_s"] = dt.busy_s()
        result["device"]["window_s"] = readings.profiled_s
        t_a, t_b = dt.extent()
        result["breakdown"] = {"device_ops": dt.top_ops(10),
                               "idle_gaps": dt.idle_gaps(t_a, t_b, 10)}
    result["checks"] = limits
    return result, limits


def _traced_window(loop, cell, seconds, done, failed, dev, tmpdir,
                   log) -> Readings:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    k = int(cell.mix["profile_units"])
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    reg = obs.metrics.install()
    try:
        with profile(activities=acts) as prof:
            tp = time.perf_counter()
            _units(loop, k, done, failed, log)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            profiled_s = time.perf_counter() - tp
        launches = reg.snapshot()
    finally:
        obs.metrics.uninstall()
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        dtrace = tracemath.DeviceTrace.load(path)
    finally:
        os.unlink(path)
    prof = None
    # the traced stretch gets the rest of the window's time, counted from
    # its own start (reading the device trace may take tens of seconds),
    # in whole periods of the mix
    period = int(cell.mix.get("period", 1))
    with obs.instrumented(sync=True, annotate=False) as (reg2, tr):
        n0 = done[0]
        ts = time.perf_counter()
        while True:
            _units(loop, 1, done, failed, log)
            if (time.perf_counter() - ts >= seconds - profiled_s
                    and (done[0] - n0) % period == 0):
                break
        spans = list(tr.events)
        counters = reg2.snapshot()
    log(f"profiled {k} units in {profiled_s:.3f} s; traced "
        f"{done[0] - n0} units")
    return Readings(spans=spans, counters=counters,
                    traced_units=done[0] - n0, device=dtrace,
                    profiled_units=k, profiled_s=profiled_s,
                    launches=launches, work=None)

"""Host syncs of resident clustering calls on the card, held against the
program's own count.

    python3 tools/sync_audit.py [--config porto] [--out FILE]

Draws a benchmark configuration's resident point set (``bench/configs``),
warms a plan for each ``min_pts`` of its sweep, then runs one call of each
under ``torch.cuda.set_sync_debug_mode("warn")``: first with no collector
installed, then with a metrics registry. Every synchronizing CUDA call
PyTorch reports is attributed to the innermost function of the program on
the stack at the time, and so is every count the program makes through
``repro_torch.obs.syncs``. Prints, per call, the synchronizing calls
without and with the registry (they must be equal: the registry may add
no sync), and per function the synchronizing calls against the counts;
writes the tables as JSON to ``--out``. Exits 1 if the registry changed
the number of syncs or the result, or if any function's counts differ
from its synchronizing calls. Needs a CUDA device. ``chip_smoke.py``
runs the same check (:func:`audit`) on its main path.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import warnings
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

from repro_torch import dbscan  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.obs import metrics, names, syncs  # noqa: E402

PROGRAM = os.path.join(ROOT, "src", "repro_torch") + os.sep
HELPER = os.path.join(PROGRAM, "obs", "syncs.py")


def where(frame) -> str:
    """``file:function:line`` of the innermost program frame from
    ``frame`` outward, the sync helper itself skipped; for a sync outside
    the program, its innermost frame outside ``warnings``."""
    first = None
    while frame is not None:
        f = frame.f_code.co_filename
        if f.startswith(PROGRAM) and f != HELPER:
            return (f"{f[len(PROGRAM):]}:{frame.f_code.co_name}:"
                    f"{frame.f_lineno}")
        if first is None and not f.endswith("warnings.py"):
            first = f"{f}:{frame.f_code.co_name}:{frame.f_lineno}"
        frame = frame.f_back
    return f"outside the program ({first})"


def by_function(lines: Counter) -> Counter:
    out = Counter()
    for k, v in lines.items():
        out[k.rsplit(":", 1)[0]] += v
    return out


class Audit:
    """Attributes synchronizing calls and the program's counts to the
    program's functions while active."""

    def __init__(self):
        self.syncs = Counter()
        self.counted = Counter()
        self._read, self._blocked = syncs.read, syncs.blocked

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        if "synchroniz" in str(message):
            self.syncs[where(sys._getframe(1))] += 1

    def __enter__(self):
        audit = self

        def read(value, site):
            audit.counted[where(sys._getframe(1))] += 1
            return audit._read(value, site)

        def blocked(site, n=1):
            audit.counted[where(sys._getframe(1))] += n
            return audit._blocked(site, n)

        syncs.read, syncs.blocked = read, blocked
        # switching the mode may sync once itself: before the hook
        torch.cuda.set_sync_debug_mode("warn")
        self._warn = warnings.catch_warnings()
        self._warn.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._hook
        return self

    def __exit__(self, *exc):
        self._warn.__exit__(*exc)
        torch.cuda.set_sync_debug_mode("default")
        syncs.read, syncs.blocked = self._read, self._blocked
        torch.cuda.synchronize()


def audit(call) -> dict:
    """Run ``call()`` (a clustering call returning a ``DBSCANResult``)
    under the audit with no collector installed, then with a metrics
    registry. ``ok`` holds when the registry changed neither the result
    nor the number of synchronizing calls, and every function's counts
    equal its synchronizing calls."""
    with Audit() as bare:
        r0 = call()
    reg = metrics.install()
    try:
        with Audit() as seen:
            r1 = call()
        snap = reg.snapshot()
    finally:
        metrics.uninstall()
    same = (torch.equal(r0.labels, r1.labels)
            and r0.n_sweeps == r1.n_sweeps)
    sites = {s["labels"]["site"]: s["value"] for fam in snap["metrics"]
             if fam["name"] == names.HOST_SYNCS for s in fam["series"]}
    s0, s1 = by_function(bare.syncs), by_function(seen.syncs)
    c1 = by_function(seen.counted)
    table = {fn: {"syncs": s1[fn], "counted": c1[fn],
                  "syncs_without_registry": s0[fn]}
             for fn in sorted(set(s0) | set(s1) | set(c1))}
    lines = {k: {"syncs": seen.syncs[k], "without": bare.syncs[k]}
             for k in sorted(set(seen.syncs) | set(bare.syncs))
             if table[k.rsplit(":", 1)[0]]["syncs"]
             != table[k.rsplit(":", 1)[0]]["counted"]
             or seen.syncs[k] != bare.syncs[k]}
    n0, n1 = sum(bare.syncs.values()), sum(seen.syncs.values())
    drift = [fn for fn, row in table.items()
             if row["syncs"] != row["counted"]]
    return {"n_sweeps": r1.n_sweeps, "backend": r1.backend,
            "syncs_without_registry": n0, "syncs_with_registry": n1,
            "host_syncs_total": sum(sites.values()), "sites": sites,
            "by_function": table, "lines_that_differ": lines,
            "same_result": same, "differs": drift,
            "ok": n0 == n1 and same and not drift}


def report(what: str, row: dict) -> None:
    """Print one audited call: totals, then per function."""
    print(f"[sync-audit] {what}: {row['n_sweeps']} sweeps; synchronizing "
          f"calls {row['syncs_without_registry']} without a registry, "
          f"{row['syncs_with_registry']} with; host_syncs_total "
          f"{row['host_syncs_total']:.0f}")
    for fn, r in row["by_function"].items():
        flag = ("" if r["syncs"] == r["counted"]
                == r["syncs_without_registry"] else "  <-- differs")
        print(f"  {fn}: syncs {r['syncs']} (without a registry "
              f"{r['syncs_without_registry']}) counted {r['counted']}{flag}")
    for k, r in row["lines_that_differ"].items():
        print(f"    {k}: syncs {r['syncs']} without {r['without']}")
    print(f"  sites: {json.dumps(row['sites'], sort_keys=True)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="porto")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from bench import data
    with open(os.path.join(ROOT, "bench", "configs",
                           f"{args.config}.json")) as f:
        cfg = json.load(f)
    dev = torch.device("cuda", 0)
    pts = data.draw(cfg, data.catalog(cfg), int(cfg["n"]),
                    data.derive_seed(int(cfg["data_seed"])), dev)
    eps = float(cfg["eps"])
    sweep = [int(m) for m in cfg["min_pts_sweep"]]
    dispatch.clear_cache()
    for m in sweep:                         # the plans, as the cell warms
        dbscan(pts, eps, m)
    torch.cuda.synchronize()
    out, ok = {"config": args.config, "device": torch.cuda.get_device_name(
        dev), "torch": torch.__version__, "calls": []}, True
    for m in sweep:
        row = audit(lambda: dbscan(pts, eps, m))
        ok &= row["ok"]
        out["calls"].append(dict(row, min_pts=m))
        report(f"{args.config} min_pts {m}", row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Validate emitted observability artifacts against their schemas.

    PYTHONPATH=src python -m repro_torch.obs.validate \\
        --metrics m.json --trace t.json [--require-span NAME ...]

Exit 0 iff every named file parses and validates (metrics snapshots
against ``metrics.SCHEMA``, traces against the Chrome trace-event form
``trace.TRACE_SCHEMA``) and every ``--require-span`` name appears in the
trace.  The schemas are the reference package's, so this reads either
package's files.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import metrics, trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="metrics snapshot JSON to validate")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="Chrome trace-event JSON to validate")
    ap.add_argument("--require-span", action="append", default=[],
                    metavar="NAME",
                    help="fail unless the trace contains a span NAME "
                    "(repeatable)")
    ap.add_argument("--require-metric", action="append", default=[],
                    metavar="NAME",
                    help="fail unless the snapshot contains metric NAME "
                    "with at least one series (repeatable)")
    args = ap.parse_args(argv)
    if not args.metrics and not args.trace:
        ap.error("nothing to validate: pass --metrics and/or --trace")

    failures = []
    if args.metrics:
        try:
            with open(args.metrics) as f:
                doc = json.load(f)
            metrics.validate_snapshot(doc)
            names = {m["name"]: m for m in doc["metrics"]}
            for want in args.require_metric:
                if want not in names or not names[want]["series"]:
                    raise ValueError(f"required metric {want!r} absent "
                                     "or empty")
            print(f"[obs] {args.metrics}: valid snapshot, "
                  f"{len(names)} metrics")
        except (OSError, ValueError, KeyError, TypeError) as e:
            failures.append(f"{args.metrics}: {e}")
    if args.trace:
        try:
            with open(args.trace) as f:
                doc = json.load(f)
            trace.validate_chrome_trace(doc)
            spans = {ev["name"] for ev in doc["traceEvents"]}
            for want in args.require_span:
                if want not in spans:
                    raise ValueError(f"required span {want!r} absent "
                                     f"(trace has {sorted(spans)})")
            print(f"[obs] {args.trace}: valid Chrome trace, "
                  f"{len(doc['traceEvents'])} events, "
                  f"{len(spans)} distinct spans")
        except (OSError, ValueError, KeyError, TypeError) as e:
            failures.append(f"{args.trace}: {e}")

    for msg in failures:
        print(f"[obs] INVALID: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""Metrics registry — named counters, gauges, and bounded-memory quantile
histograms with labeled families.

The registry is the sink every instrumented path reports into: the walks'
``evals``/``iters`` work counters, the dispatcher's plan, cache and index
build counts, and fdbscan's sweep counts. Three metric kinds:

  * :class:`Counter` — monotone float, ``inc(v)``;
  * :class:`Gauge`   — last-write-wins float, ``set(v)``;
  * :class:`Histogram` — quantile sketch over observations.  Buckets are
    log-spaced (DDSketch-style: bucket ``i`` covers ``(gamma^(i-1),
    gamma^i]`` with ``gamma = (1+a)/(1-a)``), so p50/p95/p99 come out
    with bounded *relative* error ``a`` (default 1%) from a sparse dict
    whose size is bounded by the dynamic range of the data — never by
    the sample count.

Every metric is a *family* keyed by label values (``backend=``,
``phase=``, ``engine=`` ...); label names are fixed at first use.

Disabled-by-default contract: the module-level helpers (:func:`inc`,
:func:`set_gauge`, :func:`observe`) check one module global and return
immediately when no registry is installed — an instrumentation point in
a hot host loop costs a module-global load and a ``None`` check, and a
caller that must read a device value to report it (a sync) reads it only
after checking :func:`active`.

The snapshot document is the reference package's (``SCHEMA``), so either
package's validator reads the other's files. Zero dependencies beyond the
standard library.
"""
from __future__ import annotations

import json
import math
import threading

# Version tag of the snapshot document layout, shared with the reference
# package; tests pin the format against it.
SCHEMA = "repro.obs/v1"

KINDS = ("counter", "gauge", "histogram")

# Histogram sketch parameters: 1% relative accuracy; the bucket dict is
# hard-capped (lowest buckets collapse first) as a belt-and-braces bound
# — realistic latency/work ranges use a few hundred buckets at most.
REL_ACCURACY = 0.01
MAX_BUCKETS = 4096


class Counter:
    """Monotone counter. ``inc`` rejects negative increments."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0; got {v}")
        self.value += v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded-memory quantile sketch (log buckets, relative accuracy).

    ``observe(v)`` is O(1); ``quantile(q)`` walks the sparse bucket dict.
    Non-positive observations land in a dedicated zero bucket (durations
    and sizes — the intended inputs — are never negative).  Memory is
    O(#distinct buckets), bounded by the data's dynamic range and capped
    at ``MAX_BUCKETS``, independent of ``count``.
    """

    __slots__ = ("count", "sum", "min", "max", "_zero", "_buckets",
                 "_log_gamma", "_gamma")

    def __init__(self, rel_accuracy: float = REL_ACCURACY):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._zero = 0                      # observations <= 0
        self._buckets: dict[int, int] = {}
        self._gamma = (1.0 + rel_accuracy) / (1.0 - rel_accuracy)
        self._log_gamma = math.log(self._gamma)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self._zero += 1
            return
        i = math.ceil(math.log(v) / self._log_gamma)
        self._buckets[i] = self._buckets.get(i, 0) + 1
        if len(self._buckets) > MAX_BUCKETS:        # collapse the lowest
            lo = sorted(self._buckets)[:2]
            self._buckets[lo[1]] += self._buckets.pop(lo[0])

    def bucket_count(self) -> int:
        """Number of live sketch buckets (the memory-flatness witness)."""
        return len(self._buckets)

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]); NaN on no observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1]; got {q}")
        if self.count == 0:
            return math.nan
        rank = q * (self.count - 1)
        if rank < self._zero:
            return 0.0
        seen = self._zero
        for i in sorted(self._buckets):
            seen += self._buckets[i]
            if rank < seen:
                # bucket i covers (gamma^(i-1), gamma^i]; midpoint estimate
                return 2.0 * self._gamma ** i / (self._gamma + 1.0)
        return self.max


class _Family:
    """One named metric: a dict of children keyed by label values."""

    __slots__ = ("name", "kind", "help", "label_names", "_children")

    _MAKE = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self, name: str, kind: str, help: str,
                 label_names: tuple[str, ...]):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(sorted(label_names))
        self._children: dict[tuple, object] = {}

    def labels(self, **kv):
        """The child metric for these label values (created on first use).

        Label *names* must match the family's fixed set exactly — a typo'd
        label would otherwise silently fork a parallel series.
        """
        if tuple(sorted(kv)) != self.label_names:
            raise ValueError(
                f"metric {self.name!r} has labels {self.label_names}; "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._MAKE[self.kind]()
        return child


class Registry:
    """A collection of metric families with a stable JSON snapshot.

    ``counter``/``gauge``/``histogram`` fetch-or-create a family; re-
    requesting a name with a different kind or label set raises (one name
    means one thing for the registry's whole lifetime).  ``snapshot()``
    renders the deterministic document :func:`validate_snapshot` pins —
    families sorted by name, series sorted by label values, histograms
    summarized as count/sum/min/max/p50/p95/p99 (the sketch itself is an
    implementation detail and never serialized).
    """

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, kind: str, help: str,
                labels: tuple[str, ...]) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help,
                                                     labels)
            elif fam.kind != kind:
                raise ValueError(f"metric {name!r} is a {fam.kind}, "
                                 f"requested as {kind}")
            elif fam.label_names != tuple(sorted(labels)):
                raise ValueError(
                    f"metric {name!r} has labels {fam.label_names}; "
                    f"requested {tuple(sorted(labels))}")
            if help and not fam.help:
                fam.help = help
            return fam

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> _Family:
        return self._family(name, "counter", help, tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> _Family:
        return self._family(name, "gauge", help, tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = ()) -> _Family:
        return self._family(name, "histogram", help, tuple(labels))

    def get(self, name: str, **kv):
        """The child metric for ``name``/labels, or None if absent (read
        path for stats reporting; never creates)."""
        fam = self._families.get(name)
        if fam is None:
            return None
        return fam._children.get(
            tuple(str(kv[k]) for k in fam.label_names) if fam.label_names
            else ())

    def snapshot(self) -> dict:
        """The stable, deterministic JSON-ready document (SCHEMA)."""
        metrics = []
        for name in sorted(self._families):
            fam = self._families[name]
            series = []
            for key in sorted(fam._children):
                child = fam._children[key]
                entry: dict = {"labels": dict(zip(fam.label_names, key))}
                if fam.kind == "histogram":
                    entry.update(
                        count=child.count,
                        sum=child.sum,
                        min=child.min if child.count else None,
                        max=child.max if child.count else None,
                        p50=_finite(child.quantile(0.50)),
                        p95=_finite(child.quantile(0.95)),
                        p99=_finite(child.quantile(0.99)))
                else:
                    entry["value"] = child.value
                series.append(entry)
            metrics.append({"name": name, "kind": fam.kind,
                            "help": fam.help,
                            "label_names": list(fam.label_names),
                            "series": series})
        return {"schema": SCHEMA, "metrics": metrics}

    def write_json(self, path: str) -> dict:
        doc = self.snapshot()
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        return doc


def _finite(v: float):
    return None if math.isnan(v) else v


# ---------------------------------------------------------------------- #
# the installed collector (module-global; None = instrumentation off)    #
# ---------------------------------------------------------------------- #

_active: Registry | None = None


def install(registry: Registry | None = None) -> Registry:
    """Install ``registry`` (or a fresh one) as the process-wide collector
    and return it.  Returns the *previous* state to the caller's care:
    use the value of :func:`active` beforehand to restore it."""
    global _active
    _active = registry if registry is not None else Registry()
    return _active


def uninstall() -> None:
    """Remove the collector: every instrumentation point returns to the
    dict-load + None-check no-op fast path."""
    global _active
    _active = None


def active() -> Registry | None:
    """The installed registry, or None when instrumentation is off."""
    return _active


def inc(name: str, value: float = 1.0, **labels) -> None:
    """Increment counter ``name`` (no-op when no registry is installed)."""
    reg = _active
    if reg is None:
        return
    reg.counter(name, labels=tuple(labels)).labels(**labels).inc(value)


def set_gauge(name: str, value: float, **labels) -> None:
    """Set gauge ``name`` (no-op when no registry is installed)."""
    reg = _active
    if reg is None:
        return
    reg.gauge(name, labels=tuple(labels)).labels(**labels).set(value)


def observe(name: str, value: float, **labels) -> None:
    """Record ``value`` into histogram ``name`` (no-op when disabled)."""
    reg = _active
    if reg is None:
        return
    reg.histogram(name, labels=tuple(labels)).labels(**labels).observe(value)


# ---------------------------------------------------------------------- #
# snapshot validation (CI gates artifacts through this)                  #
# ---------------------------------------------------------------------- #

def validate_snapshot(doc: dict) -> None:
    """Raise ValueError unless ``doc`` is a well-formed SCHEMA snapshot."""
    if not isinstance(doc, dict):
        raise ValueError(f"snapshot must be a dict; got {type(doc).__name__}")
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"snapshot schema {doc.get('schema')!r} != {SCHEMA!r}")
    metrics = doc.get("metrics")
    if not isinstance(metrics, list):
        raise ValueError("snapshot 'metrics' must be a list")
    seen = set()
    for m in metrics:
        name = m.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError(f"metric name must be a non-empty str; got {m}")
        if name in seen:
            raise ValueError(f"duplicate metric {name!r}")
        seen.add(name)
        if m.get("kind") not in KINDS:
            raise ValueError(f"{name}: kind {m.get('kind')!r} not in {KINDS}")
        label_names = m.get("label_names")
        if not isinstance(label_names, list):
            raise ValueError(f"{name}: label_names must be a list")
        for s in m.get("series", ()):
            labels = s.get("labels")
            if not isinstance(labels, dict) or \
                    sorted(labels) != sorted(label_names):
                raise ValueError(f"{name}: series labels {labels!r} do not "
                                 f"match label_names {label_names}")
            if m["kind"] == "histogram":
                for k in ("count", "sum", "p50", "p95", "p99"):
                    if k not in s:
                        raise ValueError(f"{name}: histogram series missing "
                                         f"{k!r}")
                if s["count"] < 0:
                    raise ValueError(f"{name}: negative count")
            else:
                if "value" not in s:
                    raise ValueError(f"{name}: series missing 'value'")

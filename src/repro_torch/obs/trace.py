"""Span tracer — nestable phase spans exported as Chrome trace-event JSON.

``span("build")`` / ``span("sweep", i=k)`` bracket *host-side* calls.
Spans nest via a per-thread stack and serialize as Chrome trace-event
*complete* events (``"ph": "X"``), so ``export(path)`` produces a file
that loads directly in Perfetto / ``chrome://tracing``. The document is the
reference package's (``TRACE_SCHEMA``), so either package's validator reads
the other's files.

Device-sync semantics: CUDA launches are asynchronous, so a span that only
measures the Python call would report launch cost, not compute cost. A span
can therefore *watch* values (``sp.watch(tensors)`` or the module-level
:func:`watch`); in ``sync=True`` mode (the default) the span close
synchronises the CUDA devices that hold the watched tensors before taking
the end timestamp (CPU tensors need none), and the event is explicitly
marked (``args["sync"] == "blocked"``) so the observer cost is visible in
the trace rather than silently attributed. ``sync=False`` is the
production mode: watches are recorded as ``"none"`` and nothing ever
blocks. A device error that surfaces at the sync propagates: a span never
hides a failed launch.

Profiler shim: with ``annotate=True`` every span also enters a
``torch.profiler.record_function``, so under a profiler capture (e.g.
:func:`profiler_session`) the same phase names appear on the profiler's
timeline; without a capture the annotation records nothing.

Disabled-by-default: with no tracer installed, :func:`span` returns a
shared no-op context manager — one module-global load per call site.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

import torch

# Version tag of the exported document; carried in the trace metadata.
TRACE_SCHEMA = "repro.obs.trace/v1"

# Event-buffer cap: tracing is for runs a human inspects, not a flight
# recorder — past the cap new events are dropped and counted.
MAX_EVENTS = 200_000


def _leaves(values):
    """The tensors inside ``values``: tensors, and (named) tuples, lists
    and dicts of them; anything else (None, plain numbers) is skipped."""
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, dict):
            yield from _leaves(v.values())
        elif isinstance(v, (tuple, list)):
            yield from _leaves(v)


def _sync(values) -> None:
    """Wait for every CUDA device that holds one of ``values``."""
    for dev in {t.device for t in _leaves(values) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Span:
    """One phase bracket; use via ``with trace.span(name, **attrs):``."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_watched", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._watched: list = []
        self._ann = None

    def watch(self, *values) -> None:
        """Register tensors whose devices to synchronise at span close
        (sync mode); in no-sync mode the values are simply dropped."""
        if self._tracer.sync:
            self._watched.extend(values)

    def __enter__(self) -> "Span":
        self._tracer._stack().append(self)
        if self._tracer.annotate:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        stack = self._tracer._stack()
        synced = False
        try:
            if self._watched and exc_type is None:
                _sync(self._watched)        # a device error propagates
                synced = True
            t1 = time.perf_counter()
        finally:
            if self._ann is not None:
                self._ann.__exit__(exc_type, exc, tb)
            if stack and stack[-1] is self:
                stack.pop()
        self._tracer._record(self.name, self._t0, t1, self.attrs, synced)


class _NoopSpan:
    """The shared disabled-path span: every method is a no-op."""

    __slots__ = ()

    def watch(self, *values) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoopSpan()


class Tracer:
    """Collects span events; ``export(path)`` writes Chrome trace JSON.

    sync: synchronise the devices of watched tensors at span close
        (timing covers the compute, observer cost is explicit); False
        never blocks.
    annotate: mirror spans into ``torch.profiler.record_function`` so a
        profiler capture shows the same phase names.
    """

    def __init__(self, sync: bool = True, annotate: bool = True,
                 max_events: int = MAX_EVENTS):
        self.sync = bool(sync)
        self.annotate = bool(annotate)
        self.max_events = int(max_events)
        self.events: list[dict] = []
        self.n_dropped = 0
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def _record(self, name: str, t0: float, t1: float, attrs: dict,
                synced: bool) -> None:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.n_dropped += 1
                return
            args = {k: _jsonable(v) for k, v in attrs.items()}
            args["sync"] = "blocked" if synced else "none"
            self.events.append({
                "name": name, "ph": "X", "cat": "repro",
                "ts": (t0 - self._epoch) * 1e6,
                "dur": (t1 - t0) * 1e6,
                "pid": os.getpid(), "tid": threading.get_ident() % 2**31,
                "args": args,
            })

    def to_dict(self) -> dict:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA,
                          "sync": "blocked" if self.sync else "none",
                          "dropped_events": self.n_dropped},
        }

    def export(self, path: str) -> dict:
        doc = self.to_dict()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return int(v)           # 0-d numpy / torch scalars
    except (TypeError, ValueError, RuntimeError):
        return str(v)


# ---------------------------------------------------------------------- #
# the installed tracer (module-global; None = tracing off)               #
# ---------------------------------------------------------------------- #

_active: Tracer | None = None


def install(tracer: Tracer | None = None, *, sync: bool = True,
            annotate: bool = True) -> Tracer:
    """Install ``tracer`` (or a fresh ``Tracer(sync=, annotate=)``) as the
    process-wide span collector and return it."""
    global _active
    _active = tracer if tracer is not None else Tracer(sync=sync,
                                                       annotate=annotate)
    return _active


def uninstall() -> None:
    global _active
    _active = None


def active() -> Tracer | None:
    """The installed tracer, or None when tracing is off."""
    return _active


def span(name: str, **attrs):
    """A span context manager on the installed tracer, or the shared
    no-op when tracing is off (the disabled fast path)."""
    t = _active
    if t is None:
        return _NOOP
    return t.span(name, **attrs)


def watch(*values) -> None:
    """Register values on the innermost open span of this thread for
    device sync at span close.  No-op when tracing is off, when the
    tracer is in no-sync mode, or outside any span."""
    t = _active
    if t is None or not t.sync:
        return
    stack = t._stack()
    if stack:
        stack[-1].watch(*values)


# ---------------------------------------------------------------------- #
# torch.profiler shim                                                    #
# ---------------------------------------------------------------------- #

@contextmanager
def profiler_session(log_dir: str):
    """Bracket a region with a ``torch.profiler`` capture (host activity,
    and CUDA activity when a card is present) and write it to
    ``log_dir/trace.json`` as a Chrome trace on exit. Yields the
    profiler; spans entered inside appear on its timeline."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------- #
# trace validation (CI gates artifacts through this)                     #
# ---------------------------------------------------------------------- #

def validate_chrome_trace(doc: dict) -> None:
    """Raise ValueError unless ``doc`` is a loadable Chrome trace-event
    document of ours (JSON-object form with complete events)."""
    if not isinstance(doc, dict):
        raise ValueError(f"trace must be a dict; got {type(doc).__name__}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace 'traceEvents' must be a list")
    if doc.get("otherData", {}).get("schema") != TRACE_SCHEMA:
        raise ValueError(f"trace schema "
                         f"{doc.get('otherData', {}).get('schema')!r} "
                         f"!= {TRACE_SCHEMA!r}")
    for ev in events:
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"event missing {k!r}: {ev}")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"complete event needs dur >= 0: {ev}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event ts must be a non-negative number: {ev}")

"""Continuous adaptive micro-batching for the serving plane (DESIGN.md §13).

The port of ``repro.serve.batching``: host code, the reference's own,
over the port's ``fdbscan._pad_size`` and ``repro_torch.obs``.

The micro-batcher coalesces arrivals *continuously*:

  * requests append to a pending queue with their arrival time;
  * a flush happens when the pending points reach the batch target
    (**full**), when the oldest pending request has waited ``max_delay_s``
    (**deadline** — bounds added latency under light load), or on drain
    (**drain** — graceful shutdown);
  * flushed probe arrays are concatenated and run as one snapshot query.
    The batch target moves on :func:`bucket_size`, the quarter-power-of-
    two ladder the streaming index pads its levels to; the reference pads
    to it to bound its compiled shapes, the port compiles nothing per
    shape and keeps the ladder so both flush the same batches.

The **adaptive** part targets the classic batching tradeoff: under heavy
load a big batch amortizes per-call overhead, but under light load
waiting for one is pure added latency.  The batcher keeps an EWMA of the
arrival rate and shrinks the batch target to what can plausibly
accumulate within one deadline window — light traffic flushes small and
fast, heavy traffic fills full buckets, and the transition needs no
tuning.

The batcher is deliberately passive (no thread of its own): ``add`` /
``ready`` / ``next_deadline`` / ``drain`` are called by the server's
worker loop under its own condition variable, and every method takes an
explicit ``now`` so tests can drive time deterministically.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np

from repro_torch.core.fdbscan import _pad_size
from repro_torch.obs import metrics as obs_metrics

# Floor of the adaptive batch target: below this, per-flush overhead
# dominates and shrinking further cannot help latency.
MIN_TARGET = 64

# EWMA smoothing for the arrival-rate estimate (per-request updates).
_RATE_ALPHA = 0.2


def bucket_size(k: int) -> int:
    """The serve bucket ladder: smallest padded size >= k.

    This is ``repro_torch.core.fdbscan._pad_size`` — the quarter-power-
    of-two ladder every level build in the streaming index pads to, the
    reference's — re-exported as the *one* ladder the serving plane uses.
    """
    return _pad_size(int(k))


class Request:
    """One admitted query request: probe points + its completion future."""

    __slots__ = ("pts", "future", "arrived_at")

    def __init__(self, pts: np.ndarray, future, arrived_at: float):
        self.pts = pts
        self.future = future
        self.arrived_at = float(arrived_at)


class Flush(NamedTuple):
    """One coalesced batch handed to the executor."""
    requests: list          # the Request objects, arrival order
    pts: np.ndarray         # concatenated probe points
    reason: str             # "full" | "deadline" | "drain"


class MicroBatcher:
    """Deadline-or-full request coalescing with an adaptive batch target.

    max_batch: hard cap on coalesced points per flush (whole requests —
        admission bounds a single request at ``max_batch`` points, so a
        request is never split).
    max_delay_s: longest a pending request may wait before a flush is
        forced (the latency bound).
    adaptive: shrink the batch target toward the points one deadline
        window can plausibly accumulate (EWMA arrival rate); ``False``
        always targets ``max_batch``.
    """

    def __init__(self, *, max_batch: int = 1024,
                 max_delay_s: float = 0.002, adaptive: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0; got {max_delay_s}")
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.adaptive = bool(adaptive)
        self._lock = threading.Lock()
        self._pending: list[Request] = []
        self._pending_pts = 0
        self._rate = 0.0                  # EWMA arrival rate, points/s
        self._last_add: float | None = None

    @property
    def pending_points(self) -> int:
        return self._pending_pts

    def target_points(self) -> int:
        """Current flush target: ``max_batch``, adaptively shrunk toward
        what one deadline window can accumulate under the observed rate."""
        if not self.adaptive:
            return self.max_batch
        reachable = self._rate * self.max_delay_s
        return int(min(self.max_batch,
                       max(MIN_TARGET, bucket_size(max(1, int(reachable))))))

    def add(self, req: Request) -> bool:
        """Queue one admitted request; True if the batch target is now
        reached (the caller should wake the executor immediately)."""
        with self._lock:
            if self._last_add is not None:
                dt = max(req.arrived_at - self._last_add, 1e-6)
                inst = len(req.pts) / dt
                self._rate += _RATE_ALPHA * (inst - self._rate)
            self._last_add = req.arrived_at
            self._pending.append(req)
            self._pending_pts += len(req.pts)
            return self._pending_pts >= self.target_points()

    def next_deadline(self, now: float) -> float | None:
        """Absolute time the oldest pending request must flush by; None
        when nothing is pending."""
        with self._lock:
            if not self._pending:
                return None
            return self._pending[0].arrived_at + self.max_delay_s

    def ready(self, now: float, *, drain: bool = False) -> Flush | None:
        """Pop one flush if due (full / deadline / drain); else None."""
        with self._lock:
            if not self._pending:
                return None
            full = self._pending_pts >= self.target_points()
            due = (now - self._pending[0].arrived_at) >= self.max_delay_s
            if not (full or due or drain):
                return None
            reason = "full" if full else ("deadline" if due else "drain")
            take, pts = [], 0
            while self._pending and (not take
                                     or pts + len(self._pending[0].pts)
                                     <= self.max_batch):
                r = self._pending.pop(0)
                take.append(r)
                pts += len(r.pts)
            self._pending_pts -= pts
        batch = (np.concatenate([r.pts for r in take])
                 if len(take) > 1 else take[0].pts)
        obs_metrics.inc("serve_flushes_total", reason=reason)
        obs_metrics.observe("serve_batch_probes", float(pts))
        return Flush(requests=take, pts=batch, reason=reason)

    def drain(self, now: float):
        """Flush everything pending (shutdown path); yields Flushes."""
        while True:
            fl = self.ready(now, drain=True)
            if fl is None:
                return
            yield fl

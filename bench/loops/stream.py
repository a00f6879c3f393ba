"""``stream``: a streaming handle over a live feed with a sliding window.

The handle is bootstrapped over the configuration's ``n`` points with
window ``n``, a write-ahead log and a checkpoint under the run's temporary
directory. Step ``t`` inserts batch ``t`` (``batch`` points; the insert
expires as many of the oldest), then queries every point of batch
``t + 1`` (each arriving point is classified once, before it is
inserted), and after every ``checkpoint_every``-th step checkpoints.
Step 0 runs in set-up. Judged after the window: the snapshot and the last
step's answers over the surviving points, ``probes_checked_per_step``
probes' counts of every step, and a restore from the checkpoint and the
log against the live handle.

With ``dry`` set the steps keep the loop's own books (batches, probes)
and leave the program out: the control puts the reference in its place.
"""
from __future__ import annotations

import gc
import os
import shutil
import tempfile

import torch

from bench.reference import dbscan_ref, stream_ref

from . import (BATCH, CLUSTER_CHECKS, DRAW, SAMPLE, BaseLoop, add_checks,
               brief, sync)
from .. import data


class Loop(BaseLoop):

    dry = False

    def setup(self) -> None:
        from repro_torch.stream import durability
        self.batch_n = int(self.mix["batch"])
        self.dir = tempfile.mkdtemp(prefix="bench-stream-", dir=self.tmpdir)
        self.wal_path = os.path.join(self.dir, "stream.wal")
        self.ckpt_path = os.path.join(self.dir, "stream.ckpt.npz")
        self.wal = durability.WriteAheadLog(self.wal_path, eps=self.eps,
                                            min_pts=self.min_pts)
        boot = self.draw(self.n, DRAW, 0)
        self.batches = [boot]           # insert-id order: gid = row
        self.total = self.n
        self.samples: list = []         # (step, total, probes, counts)
        self._next = None
        self.h = None if self.dry else self.repro_torch.stream_handle(
            boot, self.eps, self.min_pts, window=self.n, wal=self.wal,
            checkpoint_path=self.ckpt_path, device=self.device)
        self.step(0)                    # warm: an insert and a query
        sync(self.device)

    def batch(self, t: int) -> torch.Tensor:
        if self._next is not None and self._next[0] == t:
            return self._next[1]
        return self.draw(self.batch_n, BATCH, t)

    def unit(self, i: int) -> None:
        self.step(i + 1)

    def step(self, t: int) -> None:
        b = self.batch(t)
        if not self.dry:
            self.h.insert(b)
        self.batches.append(b)
        self.total += b.shape[0]
        probes = self.draw(self.batch_n, BATCH, t + 1)
        self._next = (t + 1, probes)
        if self.dry:
            self.last = (t, probes, None)
            return
        res = self.h.query(probes)
        self.last = (t, probes, res)
        k = int(self.mix["probes_checked_per_step"])
        g = data.generator(data.derive_seed(self.seed, SAMPLE, t),
                           self.device)
        pick = torch.randperm(probes.shape[0], generator=g,
                              device=self.device)[:k]
        self.samples.append((t, self.total, probes[pick],
                             torch.as_tensor(res.counts)[pick.cpu()]))
        if (t + 1) % int(self.mix["checkpoint_every"]) == 0:
            self.h.checkpoint()
        sync(self.device)

    def alive(self, total: int) -> torch.Tensor:
        """Insert ids in the window once ``total`` points were inserted."""
        return torch.arange(max(0, total - self.n), total,
                            device=self.device)

    def checks(self) -> dict:
        from repro_torch.stream import StreamingDBSCAN
        out: dict = {}
        snap = self.h.snapshot()
        live = (snap.labels.cpu(), snap.core_mask.cpu(), snap.n_clusters,
                torch.as_tensor(self.h.active_gids))
        t, probes, res = self.last
        self.h = None
        self.wal.close()
        gc.collect()
        # durability: a restore from the checkpoint and the log reads back
        # as the live handle
        restored = StreamingDBSCAN.restore(self.ckpt_path, wal=self.wal_path,
                                           device=self.device)
        rs = restored.snapshot()
        rgids = torch.as_tensor(restored.active_gids)
        same = (rgids.numel() == live[3].numel()
                and bool((rgids == live[3]).all())
                and rs.labels.numel() == live[0].numel())
        out["restore_mismatch"] = (
            int((rs.labels.cpu() != live[0]).sum()
                + (rs.core_mask.cpu() != live[1]).sum()) if same
            else max(rgids.numel(), live[3].numel(), 1))
        restored = rs = None
        self.release()
        # the live snapshot and the last step's answers, against the
        # reference over the surviving points
        allpts = torch.cat(self.batches)
        gids = self.alive(self.total)
        out["active_set_errors"] = int(
            torch.unique(torch.cat([gids.cpu(), live[3]])).numel() * 2
            - gids.numel() - live[3].numel())
        if out["active_set_errors"] == 0:
            pts = allpts[gids]
            got = dbscan_ref.check_clustering(
                pts, self.eps, self.min_pts, live[0], live[1], live[2],
                self.rounding)
            add_checks(out, got)
            self.log(f"checked the snapshot after step {t}: {brief(got)}")
            _, core, comps = got["_state"]
            got = None
            out.update(stream_ref.check_queries(
                pts, gids, core, comps, probes, res.labels, res.counts,
                res.would_be_core, self.eps, self.min_pts, self.rounding))
        else:
            for k in CLUSTER_CHECKS + ("query_count_errors",
                                       "query_label_errors",
                                       "query_core_errors"):
                out[k] = None
        # a sample of every step's counts
        bad = 0
        for s, total, pr, counts in self.samples:
            act = allpts[self.alive(total)]
            cs, cl = stream_ref.brute_counts(pr, act, self.eps,
                                             self.min_pts, self.rounding)
            c = counts.to(cs.device).long()
            bad += int(((c < cs) | (c > cl)).sum())
        out["step_count_errors"] = bad
        out["steps_checked"] = len(self.samples)
        return out

    def free(self) -> None:
        self.h = None
        self.wal.close()
        self.release()
        shutil.rmtree(self.dir, ignore_errors=True)

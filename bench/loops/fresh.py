"""``fresh``: a new point set every call, clustered with ``dbscan``
(auto), so every call plans, hashes and builds its index. Call ``i``
draws its set from (``--seed``, ``i``); ``checked_calls`` calls drawn
from the seed are judged after the window."""
from __future__ import annotations

from bench.reference import dbscan_ref

from . import DRAW, KEEP, WARM, BaseLoop, Reservoir, add_checks, brief, sync
from .. import data


class Loop(BaseLoop):

    def setup(self) -> None:
        warm = self.draw(self.n, WARM)
        self.dbscan(warm, self.min_pts)
        del warm
        sync(self.device)
        self.kept = Reservoir(int(self.mix["checked_calls"]),
                              data.derive_seed(self.seed, KEEP))

    def unit(self, i: int) -> None:
        pts = self.draw(self.n, DRAW, i)
        res = self.dbscan(pts, self.min_pts)
        sync(self.device)
        self.kept.offer((i, res.labels, res.core_mask, res.n_clusters))

    def checks(self) -> dict:
        out: dict = {}
        items, self.kept = self.kept.items, None
        self.release()
        for i, labels, core, n_clusters in items:
            pts = data.draw(self.cfg, self.catalog, self.n,
                            data.derive_seed(self.seed, DRAW, i),
                            self.device)
            got = dbscan_ref.check_clustering(
                pts, self.eps, self.min_pts, labels, core, n_clusters,
                self.rounding)
            add_checks(out, got)
            self.log(f"checked call {i}: {brief(got)}")
        out["calls_checked"] = len(items)
        return out

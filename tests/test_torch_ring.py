"""The port's dense ring (``repro_torch.distributed.ring_dbscan.ring_dbscan``)
on the CPU against the reference's live ``ring_dbscan``: the three cases of
``tests/test_distributed.py`` at P = 8 and P = 4 shards of a
``LocalMesh``, with the reference's difference-form tiles
(``use_pallas=False``) and with the tile kernels' plain versions
(``use_pallas=True``, the reference's Pallas kernels in interpret mode);
and a mesh so wide that its last shard holds only sentinels.

The live reference runs in one subprocess under 8 forced host devices
(``test_torch_ring_tree.JaxOracle``). Tolerance: zero (labels, core mask,
``n_clusters``, ``n_sweeps`` byte-equal).
"""
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

from repro_torch.distributed import ring_dbscan as rd, sharding  # noqa: E402

from conftest import separated_points  # noqa: E402
from test_torch_ring_tree import JaxOracle, assert_same  # noqa: E402

# tests/test_distributed.py's three cases: (name, points, eps, min_pts)
CASES = [
    ("sep2d", separated_points(1000, 2, eps=0.05, seed=1), 0.05, 8),
    ("sep2d_b", separated_points(512, 2, eps=0.06, seed=2), 0.06, 5),
    ("sep3d", separated_points(500, 3, eps=0.1, seed=3), 0.1, 2),
]
# 20 points on 8 shards: 3 rows a shard, the last shard all sentinels
TINY = ("tiny", separated_points(20, 2, eps=0.3, seed=6), 0.3, 3)
RUNS = ([(c, ndev, up) for c in CASES for ndev in (8, 4)
         for up in (False, True)]
        + [(TINY, 8, False), (TINY, 8, True)])


def _name(case, ndev, use_pallas):
    return f"{case[0]}_p{ndev}_{'tiles' if use_pallas else 'diff'}"


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    cases, points = [], {}
    for case, ndev, up in RUNS:
        name = _name(case, ndev, up)
        cases.append({"kind": "ring", "name": name, "eps": case[2],
                      "min_pts": case[3], "ndev": ndev, "use_pallas": up})
        points[name] = case[1]
    o = JaxOracle(str(tmp_path_factory.mktemp("oracle")), cases, points)
    yield o
    o.close()


@pytest.mark.parametrize("case,ndev,use_pallas", RUNS,
                         ids=[_name(*r) for r in RUNS])
def test_ring_dbscan_matches_live_reference(oracle, case, ndev, use_pallas):
    """On the sentinel-only shard the squares overflow to inf, and the
    norm form's ``inf - inf`` is NaN: every comparison stays false."""
    _, pts, eps, mp = case
    res = rd.ring_dbscan(pts, eps, mp, mesh=sharding.LocalMesh(ndev),
                         use_pallas=use_pallas, device="cpu")
    assert res.backend == "ring"
    name = _name(case, ndev, use_pallas)
    assert_same(res, oracle.get(name), name)

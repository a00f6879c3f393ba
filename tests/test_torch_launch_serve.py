"""The port's serving CLI (``python -m repro_torch.launch.serve``) on the
CPU at a small n: single-handle mode with a WAL, a checkpoint and
``--validate``, then ``--restore``; server mode (``--tenants``) with
``--durability-dir`` and ``--validate``, then ``--restore``. Every run
returns normally (the exit code 0 of the command line), its
``--metrics-json`` passes the port's ``obs.validate``, and it reports
under the same metric names as the reference CLI run with the same
arguments (both draw the same request stream from the seed)."""
import json

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

from repro.launch import serve as jcli  # noqa: E402

from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.obs import validate as obs_validate  # noqa: E402

N, STEPS = 512, 8
TENANTS = "a:0.04:8,b:0.06:5"


def _names(path) -> set:
    with open(path) as f:
        return {m["name"] for m in json.load(f)["metrics"]}


def _run_both(tmp_path, tag, args):
    """The port's CLI and the reference's on the same arguments, each with
    its own state directory and metrics file."""
    out = {}
    for side, main in (("port", cli.main), ("ref", jcli.main)):
        d = tmp_path / f"{tag}-{side}"
        d.mkdir(exist_ok=True)
        argv = [a.replace("{d}", str(d)) for a in args]
        argv += ["--metrics-json", str(d / "m.json")]
        if side == "port":
            argv += ["--device", "cpu"]
        out[side] = (main(argv), d / "m.json")
    return out


def test_single_handle_mode_validates_and_restores(tmp_path):
    args = ["--n", str(N), "--steps", str(STEPS), "--validate",
            "--wal", "{d}/s.wal", "--checkpoint", "{d}/s.npz",
            "--checkpoint-every", "1"]
    first = _run_both(tmp_path, "run", args)
    stats, metrics = first["port"]
    assert stats["n_points"] == first["ref"][0]["n_points"]
    assert stats["n_clusters"] == first["ref"][0]["n_clusters"]
    trace = tmp_path / "t.json"
    assert obs_validate.main(["--metrics", str(metrics)]) == 0
    assert _names(metrics) == _names(first["ref"][1])
    d = tmp_path / "run-port"
    back = cli.main(["--n", str(N), "--steps", "4", "--validate", "--restore",
                     "--wal", str(d / "s.wal"), "--checkpoint",
                     str(d / "s.npz"), "--device", "cpu",
                     "--trace", str(trace)])
    assert back["n_points"] >= stats["n_points"]
    assert obs_validate.main(["--trace", str(trace)]) == 0


def test_tenants_mode_durability_and_restore(tmp_path):
    args = ["--n", str(N), "--steps", str(STEPS), "--tenants", TENANTS,
            "--durability-dir", "{d}", "--validate"]
    first = _run_both(tmp_path, "run", args)
    stats, metrics = first["port"]
    assert obs_validate.main(["--metrics", str(metrics)]) == 0
    assert _names(metrics) == _names(first["ref"][1])
    ref = first["ref"][0]
    assert ([t["version"] for t in stats["tenants"]]
            == [t["version"] for t in ref["tenants"]])
    assert ([t["watermark"] for t in stats["tenants"]]
            == [t["watermark"] for t in ref["tenants"]])
    d = tmp_path / "run-port"
    back = cli.main(["--n", str(N), "--steps", "4", "--tenants", TENANTS,
                     "--durability-dir", str(d), "--restore", "--validate",
                     "--device", "cpu", "--metrics-json",
                     str(d / "m2.json")])
    assert obs_validate.main(["--metrics", str(d / "m2.json")]) == 0
    assert all(t["watermark"] >= stats["tenants"][0]["watermark"]
               for t in back["tenants"])
    with pytest.raises(SystemExit):
        cli.main(["--tenants", TENANTS, "--restore", "--device", "cpu"])

"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package, importing and
running the port loads neither, and without a CUDA device the entry points
refuse to run unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_reference():
    seen = 0
    for path in _sources():
        assert os.path.exists(path), path
        bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
        seen += 1
    assert seen >= 15


def test_running_the_port_loads_neither_jax_nor_the_reference():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import repro_torch
        from repro_torch.data import pointclouds
        pts = pointclouds.load("blobs", 300)
        for algorithm in ("auto", "fdbscan-densebox"):
            res = repro_torch.dbscan(pts, 0.05, 5, algorithm=algorithm,
                                     device="cpu")
            assert res.n_clusters > 0
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print("isolated")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_no_cuda_and_no_device_raises(monkeypatch):
    import numpy as np
    import repro_torch
    from repro_torch.core import dispatch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).uniform(0, 1, (50, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.dbscan(pts, 0.1, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        dispatch.plan(pts, 0.1, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.dbscan(pts, 0.1, 3, algorithm="fdbscan")
    assert repro_torch.dbscan(pts, 0.1, 3, device="cpu").labels.shape == (50,)

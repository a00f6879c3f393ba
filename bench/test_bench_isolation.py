"""The benchmark stands apart: no module under ``bench/`` imports JAX or the
JAX package ``repro`` (top-level names compared whole, so ``repro_torch``
is allowed), the reference under ``bench/reference/`` imports nothing of
the program, nothing under ``bench/`` reads the JAX package's
``benchmarks/``, and a run of the harness loads none of them."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources(top: Path):
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield Path(dirpath) / f


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    seen = 0
    for path in _sources(BENCH):
        bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
        seen += 1
    assert seen >= 20


def test_the_reference_imports_nothing_of_the_program():
    seen = 0
    for path in _sources(BENCH / "reference"):
        roots = set(_imported_roots(path))
        assert "repro_torch" not in roots, path
        assert roots <= {"__future__", "itertools", "math", "typing",
                         "numpy", "torch"}, (path, roots)
        seen += 1
    assert seen >= 2


def test_nothing_reads_the_jax_packages_benchmarks():
    for path in _sources(BENCH):
        if path.name.startswith("test_bench_"):
            continue
        text = path.read_text()
        assert "benchmarks" not in text, path
        assert "BENCH_" not in text, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        import time
        import torch
        torch.set_num_threads(1)
        from pathlib import Path
        from bench import harness, run
        cell = harness.load_cell(Path({str(ROOT)!r}), "hacc.fresh")
        cell = cell._replace(cfg=dict(cell.cfg, n=1100, eps=0.075))
        res, _ = harness.run(cell, 5, 0.01, False, "cpu",
                             time.perf_counter(), lambda m: None)
        assert res["correct"], res
        assert not run.forbidden_modules(), run.forbidden_modules()
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-3000:]

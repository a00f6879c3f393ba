"""The benchmark of ``repro_torch`` on one H100 (``BENCHMARK.json`` at the
repository's root names its cells and metrics).

    python3 -m bench.run --workload <cell> --seed <n> --seconds 40 --trace 0|1
    python3 -m bench.control --workload <cell> --seeds <n> <n> <n>

``configs/`` holds the configurations, ``generators/`` the surrogate
generators they name, ``mixes/`` the traffic mixes, ``loops/`` one loop a
kind of mix, ``metrics/`` one reader a per-layer metric, and
``reference/`` the plain reference that decides ``correct``; each file is
found by its name. The ``test_bench_*.py`` files run on the CPU at tiny
sizes.
"""

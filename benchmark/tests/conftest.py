"""The benchmark's own tests: its generators, arithmetic, discovery and
imports, and a rehearsal of every cell on the CPU at a tiny size through
the harness itself (device="cpu", a path only these tests take)."""

import pathlib
import sys

import pytest

HOME = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HOME))
sys.path.insert(1, str(HOME.parent))

# Configuration sizes a CPU test run can hold, by configuration: 150
# orders (about 600 rows, 75 KB) and a 64 KiB text pool.
SMALL = {
    "tpch-lineitem-gzip6": {"scale_factor": 0.001, "text_pool_bytes": 1 << 16},
}


@pytest.fixture(scope="session")
def listed():
    """The cells BENCHMARK.json lists."""
    import harness

    return [cell["name"] for cell in harness.Bench().spec["workloads"]]


@pytest.fixture(scope="session")
def bench():
    import harness

    return harness.Bench()


def rehearse(bench, workload, *, trace=False, impl="program", seconds=0.3,
             seed=2**31 + 7):
    """One run of `workload` on the CPU at its SMALL size."""
    import time

    import harness

    cfg = bench.cell(workload)["config"]
    return harness.run_cell(bench, workload, seed, seconds, trace,
                            t0=time.perf_counter(), device="cpu",
                            overrides=SMALL[cfg], impl=impl)

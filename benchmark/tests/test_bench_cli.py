"""The command itself: without a card, or without the program beside it, it
prints no result and exits with another code than 0."""

import shutil
import subprocess
import sys

import pytest

from conftest import HOME

ARGS = ["--workload", "tpch-lineitem-gzip6.compress-tensor", "--seed",
        str(2**31 + 3), "--seconds", "1", "--trace", "0"]


def _run(root):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=root, capture_output=True, text=True,
                          timeout=600)


def test_without_a_card_it_prints_nothing_and_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = _run(HOME.parent)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_with_only_the_benchmark_files_it_prints_nothing_and_fails(tmp_path):
    shutil.copytree(HOME, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HOME.parent / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""

"""Each cell on the card, briefly, in one process: correct as the program, not
correct as the control. Skips where there is no CUDA card."""

import json
import subprocess
import sys

import pytest

from conftest import HOME
from test_bench_rehearsal import LISTED


@pytest.mark.parametrize("cell", LISTED)
def test_the_program_is_correct_and_the_control_is_not_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/readings.py", "--workload", cell,
         "--seeds", str(2**31 + 101), "--seconds", "1", "--impl", "both"],
        cwd=HOME.parent, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert [(line["impl"], line["correct"]) for line in lines] == [
        ("program", True), ("control", False)], lines

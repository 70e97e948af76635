"""Every cell, driven through the harness on the CPU at a tiny size: the
paths, the discovery, the reference and the shape of the last line. No
number here is a device number, and none is printed."""

import json

import pytest

from conftest import rehearse

LISTED = ["tpch-lineitem-gzip6.compress-tensor",
          "tpch-lineitem-gzip6.decode-foreign"]


def test_the_cells_are_these(listed):
    assert listed == LISTED


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", LISTED)
def test_a_cell_runs_and_is_correct(bench, cell, trace):
    result, lines = rehearse(bench, cell, trace=trace)
    assert result["correct"], result
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in bench.spec[kind]
               if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) <= set(allowed)
    for name, metric in result["metrics"].items():
        assert metric["unit"] == allowed[name]
        assert isinstance(metric["value"], float)
    if not trace:
        assert "setup_s" in result["metrics"]
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
    assert [line.split()[1] for line in lines] == list(result["checks"])
    json.dumps(result)

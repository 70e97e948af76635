"""What `correct` is decided by fails where it should: the control (the
reference in the program's place, at a level whose match search is cut, or
with one byte of a decode changed), an encoder at a lower level, and a
run with the timed path broken underneath in each way the cell can be
broken: its state returned unchanged, half of its work left out, an answer
altered where it is produced. (The cells run on one card, so there is no
exchange between cards to leave out.)"""

import pytest

from conftest import rehearse
from test_bench_rehearsal import LISTED


@pytest.mark.parametrize("cell", LISTED)
def test_the_control_is_not_correct(bench, cell):
    result, _ = rehearse(bench, cell, impl="control")
    assert not result["correct"]


def test_the_compress_control_fails_on_size_alone(bench):
    # The reference at a level whose match search is cut makes a sound
    # member of the payload: only its size gives it away.
    cell = "tpch-lineitem-gzip6.compress-tensor"
    control, _ = rehearse(bench, cell, impl="control")
    program, _ = rehearse(bench, cell)
    size = "stream_over_ref_pct"
    assert control["checks"]["bad_outputs"]["value"] == 0
    assert control["checks"][size]["value"] > \
        control["checks"][size]["at_most"]
    assert program["checks"][size]["value"] < \
        program["checks"][size]["at_most"]


def _flip(data: bytes, at: int) -> bytes:
    out = bytearray(data)
    out[at] ^= 0x40
    return bytes(out)


def _faults(real):
    """{(entry, fault): replacement} for the program's entry points."""
    def compress(fault):
        def fn(src, *args, **kwargs):
            data = bytes(src.cpu().numpy()) if hasattr(src, "cpu") else src
            if fault == "unchanged":
                return data
            if fault == "half":
                return real["compress"](src[:len(data) // 2], *args, **kwargs)
            out = real["compress"](src, *args, **kwargs)
            return _flip(out, len(out) // 2)
        return fn

    def uncompress(fault):
        def fn(blob, *args, **kwargs):
            if fault == "unchanged":
                return blob
            out = real["uncompress"](blob, *args, **kwargs)
            return out[:len(out) // 2] if fault == "half" else _flip(
                out, len(out) // 3)
        return fn

    return {"compress": compress, "uncompress": uncompress}


ENTRY = {"tpch-lineitem-gzip6.compress-tensor": "compress",
         "tpch-lineitem-gzip6.decode-foreign": "uncompress"}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", LISTED)
def test_a_broken_timed_path_is_not_correct(bench, cell, fault, monkeypatch):
    import zippy_tpu_torch as zt

    entry = ENTRY[cell]
    real = {name: getattr(zt, name) for name in ENTRY.values()}
    monkeypatch.setattr(zt, entry, _faults(real)[entry](fault))
    result, _ = rehearse(bench, cell)
    assert not result["correct"], (cell, fault, result["checks"])


def test_an_encoder_that_searches_less_is_not_correct(bench, monkeypatch):
    # The program's own level 1 put where the cell asks for level 6.
    import zippy_tpu_torch as zt

    real = zt.compress

    def level_one(src, level, *args, **kwargs):
        return real(src, 1, *args, **kwargs)

    monkeypatch.setattr(zt, "compress", level_one)
    result, _ = rehearse(bench, "tpch-lineitem-gzip6.compress-tensor")
    assert result["checks"]["bad_outputs"]["value"] == 0
    assert not result["correct"], result["checks"]

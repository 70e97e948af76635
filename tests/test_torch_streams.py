"""Whole zippy_tpu_torch DEFLATE streams against zippy_tpu's, on the CPU.

The port runs its plain PyTorch path (device="cpu"). Byte identity is held
with both encoders on the same ideal depths (see test_torch_deflate.py for
why the jitted reference cannot share jnp.log2's); with the port's own
depths every stream still decodes and stays within 1% of the reference.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import mixed_payload, shared_depth  # noqa: E402,F401
from zippy_tpu import native  # noqa: E402
from zippy_tpu.ops import deflate_device as jd  # noqa: E402
from zippy_tpu_torch import profiling  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402
from zippy_tpu_torch.ops import huffman_kernels as hk  # noqa: E402


def _payloads(bs: int) -> list[bytes]:
    """Payloads of tests/test_device.py, cut to two or three blocks (one
    group shape, so the reference compiles few variants)."""
    rng = np.random.default_rng(23)
    return [
        mixed_payload(3 * bs - 17),
        rng.integers(0, 256, 2 * bs + 5, dtype=np.uint8).tobytes(),  # literals
        b"ab" * bs + bytes(bs),                                      # runs
        bytes(bytearray(range(256)) * (3 * bs // 256)),
        ((b"abcdef" * 17)[:100] * (3 * bs // 100)),                  # odd period
        (rng.integers(0, 256, bs // 2, dtype=np.uint8).tobytes()
         + b"the quick brown fox " * (bs // 8))[:3 * bs - 1],
    ]


# ---------------------------------------------------------------------------
# Whole streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("bs", [2048, 4096])
def test_deflate_byte_identical_given_same_depths(shared_depth, level, bs):
    for i, data in enumerate(_payloads(bs)):
        ref = jd.deflate(data, level, block_size=bs)
        got = td.deflate(data, level, bs, device="cpu")
        assert got == ref, (level, bs, i, len(ref), len(got))


def test_deflate_array_lits_only_byte_identical(shared_depth):
    data = (b"the quick brown fox jumps over the lazy dog\n" * 300)[:3 * 4096]
    ref = jd.deflate_array(jnp.asarray(np.frombuffer(data, np.uint8)), -2,
                           block_size=4096)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    assert td.deflate_array(x, -2, 4096) == ref
    assert td.deflate(data, -2, 4096, device="cpu") == ref


@pytest.mark.parametrize("level", [1, 6, 9])
def test_deflate_own_depth_decodes_within_one_percent(level):
    for data in _payloads(4096)[:3] + [b"xy"]:
        ref = jd.deflate(data, level, block_size=4096)
        got = td.deflate(data, level, 4096, device="cpu")
        assert zlib.decompress(got, wbits=-15) == data
        assert len(got) <= len(ref) * 1.01, (level, len(got), len(ref))


def _reference_stream(data: bytes, level: int, bs: int) -> bytes:
    if level == -2:     # zippy_tpu's deflate runs its host codec there
        return jd.deflate_array(jnp.asarray(np.frombuffer(data, np.uint8)),
                                -2, block_size=bs)
    return jd.deflate(data, level, block_size=bs)


@pytest.mark.parametrize("level", [-2, 1, 6, 9])
def test_encoder_splices_the_tables_headers(shared_depth, monkeypatch,
                                            level):
    """The stream takes the header words that K5 (on the CPU, its plain
    version) wrote: with make_dynamic_header refusing every caller but the
    plain version, deflate and deflate_entries still give the reference's
    bytes. The join (K10's plain version) takes every row of deflate and
    of deflate_entries, join.rows counts them, and the host splice takes
    none."""
    bs = 2048
    payloads = _payloads(bs)[:2] + [b"the header of one short block"]
    want = [_reference_stream(p, level, bs) for p in payloads]
    header, plain = td.make_dynamic_header, td.huffman_tables_plain
    dynamic = []

    def tables(ll_hist, dist_hist, n):
        with monkeypatch.context() as m:
            m.setattr(td, "make_dynamic_header", header)
            tab = plain(ll_hist, dist_hist, n)
        dynamic.append(int((tab["mode"] == 2).sum()))
        return tab

    def refuse(*args):
        raise AssertionError("a dynamic header built on the host")

    monkeypatch.setattr(hk, "huffman_tables", tables)
    monkeypatch.setattr(td, "make_dynamic_header", refuse)
    profiling.enable()
    try:
        joined_dynamic = 0
        for p, w in zip(payloads, want):
            with profiling.call("compress"):
                assert td.deflate(p, level, bs, device="cpu") == w
            (rec,) = profiling.recent(1)
            assert rec.counters["join.rows"] == -(-len(p) // bs)
            assert "splice.header_rows" not in rec.counters
            joined_dynamic += sum(dynamic)
            dynamic.clear()
        assert joined_dynamic > 0
        with profiling.call("compress"):
            assert td.deflate_entries(payloads, level, bs, "cpu") == want
        (rec,) = profiling.recent(1)
        assert rec.counters["join.rows"] == sum(-(-len(p) // bs)
                                                for p in payloads)
        assert "splice.header_rows" not in rec.counters
        assert sum(dynamic) > 0
    finally:
        profiling.disable()


def test_group_size_decides_no_bytes(monkeypatch):
    data = mixed_payload(5 * 2048 + 99, seed=11)
    default = [td.deflate(data, lv, 2048, device="cpu") for lv in (1, 6, -2)]
    monkeypatch.setattr(td, "_group_size", lambda k, block_size: 1)
    assert [td.deflate(data, lv, 2048, device="cpu")
            for lv in (1, 6, -2)] == default


@pytest.mark.parametrize("level", list(range(-2, 10)))
def test_empty_input_matches_host_codec(level):
    assert td.deflate(b"", level, device="cpu") == native.deflate(b"", level)
    empty = torch.zeros(0, dtype=torch.uint8)
    assert td.deflate_array(empty, level) == native.deflate(b"", level)


def test_stored_level_matches_host_codec():
    data = mixed_payload(150_000, seed=13)
    got = td.deflate(data, 0, device="cpu")
    assert zlib.decompress(got, wbits=-15) == data
    assert got == native.deflate(data, 0)


def test_default_level_maps_as_the_reference_does(shared_depth):
    """Level -1 runs level 1's matcher on a tensor (zippy_tpu's
    deflate_array takes `max(level, 1)`) and level 6's on host bytes."""
    data = mixed_payload(2 * 4096, seed=17)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    got = td.deflate_array(x, -1, 4096)
    assert got == jd.deflate_array(jnp.asarray(np.frombuffer(data, np.uint8)),
                                   -1, block_size=4096)
    assert got == td.deflate_array(x, 1, 4096)
    assert zlib.decompress(got, wbits=-15) == data
    got = td.deflate(data, -1, 4096, device="cpu")
    assert got == jd.deflate(data, -1, block_size=4096)
    assert got == td.deflate(data, 6, 4096, device="cpu")


@pytest.mark.parametrize("block_size", [0, td.MIN_BLOCK - 1,
                                        (1 << 17) - td.HIST + 1])
def test_block_size_out_of_range_raises(block_size):
    with pytest.raises(td.ZippyError):
        td.deflate(b"abc" * 100, 6, block_size, device="cpu")

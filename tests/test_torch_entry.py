"""zippy_tpu_torch's driver hooks and the deflate_device functions behind
them, against zippy_tpu's, on the CPU.

compress_block_fixed has no float step, so it is held bit for bit to the
reference. encode_block builds Huffman tables from float depths, so both
sides take the port's depths (the `shared_depth` fixture, as in
tests/test_torch_deflate.py). build_code_lengths is host integer work.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from _torch_parity import mixed_payload, one_thread, shared_depth  # noqa: E402,F401
from zippy_tpu.ops import deflate_device as jd  # noqa: E402
from zippy_tpu_torch import entry as ze  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402

N = 4096


def _padded(data: bytes, hist: int = 0) -> np.ndarray:
    pad = np.zeros(hist + N + td.PAD, np.uint8)
    arr = np.frombuffer(data, np.uint8)[: hist + N]
    pad[: arr.size] = arr
    return pad


def _fixed_stream(words: torch.Tensor, total_bits) -> bytes:
    """The packed payload behind a final fixed-Huffman block header."""
    out = td._ByteBitAppender()
    td._append_block(out, "fixed", None, words.numpy().astype(np.uint32),
                     int(total_bits), None, 0, True)
    return bytes(out.out)


def _assert_block_equals(ref, got):
    """compress_block_fixed's four outputs against the reference's: the
    words as int32 bit patterns of its uint32 words, every word exactly;
    the bit count and the histograms as integers."""
    assert got[0].dtype == torch.int32
    assert np.array_equal(np.asarray(ref[0]).astype(np.uint32).view(
        np.int32), got[0].numpy())
    for r, g in zip(ref[1:], got[1:]):
        assert np.array_equal(np.asarray(r).astype(np.int64), g.numpy())


@pytest.mark.parametrize("k,lazy", [(2, False), (4, True), (12, True)])
def test_compress_block_fixed_bit_exact(one_thread, k, lazy):
    data = mixed_payload(N, seed=11)
    pad = _padded(data)
    n = N - 9
    ref = jd.compress_block_fixed(jnp.asarray(pad), jnp.int32(n), k=k,
                                  lazy=lazy)
    got = td.compress_block_fixed(torch.from_numpy(pad), n, k=k, lazy=lazy)
    _assert_block_equals(ref, got)
    assert zlib.decompress(_fixed_stream(got[0], got[1]), -15) == data[:n]


def test_encode_block_is_a_group_row_and_the_reference(one_thread,
                                                       shared_depth):
    data = mixed_payload(3 * N, seed=13)
    hist, hist_len = 2048, 1500
    rows = [_padded(data, hist), _padded(data[N:], hist)]
    lens = torch.tensor([N - 3, N])
    hls = torch.tensor([hist_len, hist])
    group = td._encode_group(torch.from_numpy(np.stack(rows)), lens, hls,
                             k=12, lazy=True, hist=hist)
    got = td.encode_block(torch.from_numpy(rows[0]), N - 3, hist_len, k=12,
                          lazy=True, hist=hist)
    ref = jax.jit(jd.encode_block, static_argnames=(
        "k", "lazy", "hist", "min3", "lits_only"))(
        jnp.asarray(rows[0]), jnp.int32(N - 3), jnp.int32(hist_len), k=12,
        lazy=True, hist=hist)
    assert set(got) == set(ref)
    for key in ref:
        assert torch.equal(got[key], group[key][0]), key
        want = np.asarray(ref[key])
        if key == "words":
            # int32 bit patterns of the reference's uint32 words.
            assert got[key].dtype == torch.int32
            want = want.astype(np.uint32).view(np.int32)
        assert np.array_equal(want.astype(np.int64), got[key].numpy()), key


def _histograms(size: int) -> list:
    rng = np.random.default_rng(21)
    cases = [np.zeros(size, np.int64)]
    for active in (1, 2):
        freq = np.zeros(size, np.int64)
        freq[rng.choice(size, active, replace=False)] = rng.integers(
            1, 1000, active)
        cases.append(freq)
    for _ in range(12):
        freq = (rng.zipf(1.3, size) % 5000) * (rng.random(size) < 0.6)
        cases.append(freq.astype(np.int64))
    cases.append(2 ** rng.integers(0, 20, size).astype(np.int64))
    return cases


@pytest.mark.parametrize("limit,size", [(7, 19), (15, 286), (15, 30)])
def test_build_code_lengths_equals_reference(limit, size):
    for freq in _histograms(size):
        got = td.build_code_lengths(freq, limit)
        assert got.dtype == np.int32
        assert np.array_equal(got, jd.build_code_lengths(freq, limit)), freq


def test_make_dynamic_header_builds_its_cl_lens_as_the_reference():
    rng = np.random.default_rng(5)
    for _ in range(8):
        ll = td.build_code_lengths(
            (rng.zipf(1.4, 286) % 3000) * (rng.random(286) < 0.5), 15)
        ll[256] = max(ll[256], 1)
        d = td.build_code_lengths(rng.integers(0, 50, 30), 15)
        assert td.make_dynamic_header(ll, d) == jd.make_dynamic_header(ll, d)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_devices(one_thread, capsys, n):
    data, blob = ze.dryrun_multichip(n, ["cpu"] * n)
    assert zlib.decompress(blob, -15) == data
    assert capsys.readouterr().out.startswith(f"dryrun_multichip({n}): OK")


def test_dryrun_multichip_needs_cards_or_a_device_list():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(ZippyError, match="devices="):
        ze.dryrun_multichip(2)
    with pytest.raises(ZippyError):
        ze.dryrun_multichip(2, ["cpu"])


def test_entry_step_equals_reference(one_thread):
    step, args = ze.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = step(*args)
    ref_step, ref_args = graft.entry()
    ref = ref_step(*ref_args)
    _assert_block_equals(ref, got)
    block = args[0][: td.BLOCK].numpy().tobytes()
    assert zlib.decompress(_fixed_stream(got[0], got[1]), -15) == block

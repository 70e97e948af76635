"""zippy_tpu_torch's checksums against zlib, zippy_tpu.ops.checksums and the
Pallas kernels (interpreter mode), on the CPU.

On a CPU tensor the kernel wrappers run their plain PyTorch versions; the
CUDA kernels themselves are held against those plain versions on the card
by chip_smoke.py.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax.experimental.pallas")
import jax.numpy as jnp  # noqa: E402

from zippy_tpu.ops import checksums as jc  # noqa: E402
from zippy_tpu.ops import pallas_checksums as pc  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import checksum_kernels as ck  # noqa: E402
from zippy_tpu_torch.ops import checksums as tc  # noqa: E402

SIZES = [0, 1, 100, 511, 512, 513, 4096, 32769, 100000, 1 << 20]


def _data(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, n).astype(np.uint8).tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_checksums_match_zlib_and_reference(n):
    data = _data(n)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    adler = tc.adler32_device(data, device="cpu")
    crc = tc.crc32_device(data, device="cpu")
    assert adler == zlib.adler32(data) == jc.adler32_device(data)
    assert crc == zlib.crc32(data) == jc.crc32_device(data)
    assert tc.adler32_device(x) == adler
    assert tc.crc32_device(x) == crc


@pytest.mark.parametrize("nchunks", [128, 1024])
def test_adler_chunks_match_pallas_kernel(nchunks):
    chunks = np.frombuffer(_data(nchunks * ck.CHUNK), np.uint8).reshape(
        nchunks, ck.CHUNK)
    s_ref, w_ref = pc._adler_chunks_pallas(jnp.asarray(chunks))
    s, w = ck.adler_chunks(torch.from_numpy(chunks.copy()))
    assert np.array_equal(np.asarray(s_ref).astype(np.int64), s.numpy())
    assert np.array_equal(np.asarray(w_ref).astype(np.int64), w.numpy())
    assert s.dtype == w.dtype == torch.int32

    n, total = nchunks * ck.CHUNK - 77, nchunks * ck.CHUNK
    ref = pc._combine_chunks(s_ref, w_ref, jnp.uint32(n), jnp.uint32(total))
    assert ck.combine_chunks(s, w, n, total) == int(ref)


@pytest.mark.parametrize("nrows", [128, 2048])
def test_crc_rows_match_pallas_kernel(nrows):
    rows = np.frombuffer(_data(nrows * ck.CRC_ROW_BYTES), np.uint8).reshape(
        nrows, ck.CRC_ROW_BYTES)
    words = rows.view("<u4").astype(np.int64).astype(np.int32)
    ref = pc._crc_rows_pallas(jnp.asarray(words))
    got = ck.crc_rows(torch.from_numpy(rows.copy()))
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(ref).astype(np.uint32),
                          got.numpy().view(np.uint32))

    init = jc.crc_shift_register(0xFFFFFFFF, rows.size)
    assert ck.combine_rows(got, init) == int(
        pc._crc_combine_rows(ref, jnp.uint32(init)))
    assert ck.combine_rows(got, init) == zlib.crc32(rows.tobytes())


@pytest.mark.parametrize("nrows", [1, 3, 5, 129])
def test_crc_combine_rows_any_row_count(nrows):
    """The port folds any row count (a zero row in front of an odd level);
    the reference needs a power of two."""
    data = _data(nrows * ck.CRC_ROW_BYTES - 3)
    assert tc.crc32_device(data, device="cpu") == zlib.crc32(data)


def test_plain_matrices_equal_reference():
    assert np.array_equal(ck.crc_matrices().astype(np.int64).astype(np.int32),
                          pc._crc_matrices())
    assert np.array_equal(tc._word_bit_columns(), jc._word_bit_columns())
    assert np.array_equal(tc._tree_matrices(), jc._tree_matrices())
    assert np.array_equal(tc._crc_word_tables(), jc._crc_word_tables())


def test_host_combines_equal_reference():
    rng = np.random.default_rng(5)
    for _ in range(20):
        a, b = _data(int(rng.integers(0, 3000))), _data(int(rng.integers(0, 3000)))
        ca, cb = zlib.crc32(a), zlib.crc32(b)
        aa, ab = zlib.adler32(a), zlib.adler32(b)
        assert tc.crc32_combine(ca, cb, len(b)) == zlib.crc32(a + b)
        assert tc.crc32_combine(ca, cb, len(b)) == jc.crc32_combine(ca, cb, len(b))
        assert tc.adler32_combine(aa, ab, len(b)) == zlib.adler32(a + b)
        reg = int(rng.integers(0, 1 << 32))
        nb = int(rng.integers(0, 1 << 20))
        assert tc.crc_shift_register(reg, nb) == jc.crc_shift_register(reg, nb)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(ZippyError):
        tc.crc32_device(b"abc")
    with pytest.raises(ZippyError):
        tc.adler32_device(b"abc")


def test_wrappers_check_their_input():
    with pytest.raises(ZippyError):
        ck.adler_chunks(torch.zeros(2, 512, dtype=torch.uint8))
    with pytest.raises(ZippyError):
        ck.crc_rows(torch.zeros(2, 512, dtype=torch.int32))
    with pytest.raises(ZippyError):
        tc.crc32_device(torch.zeros(4, 4, dtype=torch.uint8))

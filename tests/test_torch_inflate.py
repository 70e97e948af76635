"""The port's device decode stages held against zippy_tpu's on the CPU: the
comparison tables, token extraction (K4's plain version) and every tile's
bytes, the reference's jitted `_decode_tile` running on JAX's CPU backend."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zippy_tpu.ops import inflate_device as ref  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import inflate_device as port  # noqa: E402
from zippy_tpu_torch.ops import inflate_kernels as ik  # noqa: E402
from _torch_parity import (  # noqa: E402,F401
    DEEP_CHAINS, mixed_payload, one_thread, random_bytes, raw_deflate)

pytestmark = pytest.mark.usefixtures("one_thread")

HALO = port.HALO


def _mixed_stored_stream() -> bytes:
    """Dynamic and stored blocks in one stream: zlib stores the random part,
    and the text after it matches back into the text before."""
    text = mixed_payload(200_000, 33)
    return raw_deflate(text + random_bytes(150_000, 34) + text, 6)


STREAMS = {
    "three_tiles": lambda: raw_deflate(
        mixed_payload(3 * port.CFG_S.tile_out + 12345, 31), 6),
    "fixed_multiblock": lambda: raw_deflate(
        mixed_payload(120_000, 32), 6, mem_level=1, strategy=zlib.Z_FIXED),
    "stored_and_literals": _mixed_stored_stream,
    "deep_chains": lambda: raw_deflate(DEEP_CHAINS * 4, 9),
}


def _tile_packs(blob):
    index = ref.build_decode_index(blob)
    cfg = ref._pick_cfg(index["total_out"])
    for tile in ref._plan_tiles(index, cfg):
        nrounds = ref._nrounds_for_depth(tile.depth, cfg)
        yield index, cfg, tile, nrounds, ref._tile_pack(blob, index, tile,
                                                          cfg, nrounds)


def _ref_extract_inputs(pack, cfg):
    """The reference's `_decode_tile` parse of a pack (its lines 568-585)."""
    off = 2
    words = pack[off:off + cfg.nwords]
    off += cfg.nwords
    seg = pack[off:off + 3 * cfg.nseg].astype(np.int32).reshape(3, cfg.nseg)
    off += 4 * cfg.nseg + 3 * cfg.nsto
    lens8 = pack[off:off + (318 * cfg.nblk + 3) // 4].view(np.uint8)[
        :318 * cfg.nblk].reshape(cfg.nblk, 318)
    return jnp.asarray(words), seg, jnp.asarray(lens8)


def _port_pack(pack) -> torch.Tensor:
    return torch.from_numpy(pack.view(np.int32).copy())


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_cmp_tables_equal_reference(name):
    index = ref.build_decode_index(STREAMS[name]())
    lens = index["block_lens"].astype(np.int32)
    assert lens.shape[0] >= 1
    for cols, ent in ((slice(0, 288), ref._LL_ENT),
                      (slice(288, 318), ref._D_ENT)):
        want = ref._cmp_tables(jnp.asarray(lens[:, cols]), jnp.asarray(ent))
        got = port._cmp_tables(torch.from_numpy(lens[:, cols].copy()),
                               torch.from_numpy(ent.astype(np.int64)))
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_extract_equals_reference(name):
    """K4's plain version (through the wrapper, on CPU tensors) gives the
    reference's packed tokens exactly, on every tile of real streams."""
    for index, cfg, tile, _, pack in _tile_packs(STREAMS[name]()):
        words, seg, lens8 = _ref_extract_inputs(pack, cfg)
        tabs = ref._build_lane_tables(lens8, jnp.asarray(seg[1]))
        want = np.asarray(ref._extract(words, jnp.asarray(seg[0]),
                                       jnp.asarray(seg[2]), tabs, 32))
        p_words, bit, blk, ntok, _, p_lens8 = port._unpack(_port_pack(pack),
                                                           cfg)
        tables = port._block_tables(p_lens8)
        got = ik.inflate_extract(p_words, bit, blk, ntok, tables, 32)
        assert got.shape == (32, cfg.nseg) and got.dtype == torch.int32
        assert np.array_equal(want, got.numpy())
        assert int((want != 0).sum()) == int(seg[2].sum())


def _decode_tiles_against_reference(blob, want_cfg):
    halo_r = jnp.zeros(HALO, jnp.uint8)
    acc = (jnp.uint32(1), jnp.uint32(0))
    halo_p = torch.zeros(HALO, dtype=torch.uint8)
    ntiles = 0
    for index, cfg, tile, nrounds, pack in _tile_packs(blob):
        assert cfg == want_cfg
        out_r, halo_r, *acc = ref._decode_tile(jnp.asarray(pack), halo_r,
                                               *acc, k=32, cfg=cfg)
        out_p = port._decode_tile(_port_pack(pack), halo_p, nrounds,
                                  port._tile_stored(index, tile), k=32,
                                  cfg=cfg)
        assert out_p.shape == (HALO + cfg.tile_out,)
        body = slice(HALO, HALO + tile.used)
        assert np.array_equal(out_p[body].numpy(), np.asarray(out_r)[body])
        halo_p = out_p[tile.used:tile.used + HALO]
        assert np.array_equal(halo_p.numpy(), np.asarray(halo_r))
        ntiles += 1
    return ntiles


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_tiles_equal_reference(name):
    """Each tile's bytes and the halo it hands on equal the reference's
    `_decode_tile`, tile after tile (CFG_S)."""
    ntiles = _decode_tiles_against_reference(STREAMS[name](), port.CFG_S)
    assert ntiles >= (3 if name == "three_tiles" else 1)


def test_tile_equals_reference_at_cfg_l():
    data = mixed_payload(8 * port.CFG_S.tile_out + 54321, 35)
    assert _decode_tiles_against_reference(raw_deflate(data, 6),
                                           port.CFG_L) >= 1


def test_ffill_matches_the_shifted_selects():
    """Where no gap exceeds the reference's 511-position reach, the forward
    fill (`_ffill`) equals its 9 shifted selects."""
    rng = np.random.default_rng(36)
    n = 5000
    flag_at = np.zeros(n, bool)
    flag_at[np.cumsum(rng.integers(1, 120, 40))] = True
    vals = np.where(flag_at, rng.integers(1, 1 << 20, n), 0).astype(np.int32)
    other = rng.integers(0, 1 << 20, n).astype(np.int32)
    want = ref._ffill_span(jnp.asarray(vals), jnp.asarray(other))
    _, *got = port._ffill(torch.from_numpy(vals != 0),
                          torch.from_numpy(vals), torch.from_numpy(other))
    last = int(np.flatnonzero(flag_at).max())
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w)[:last + 1], g.numpy()[:last + 1])


def test_extract_wrapper_checks_its_arguments():
    words = torch.zeros(8, dtype=torch.int32)
    seg = torch.zeros(4, dtype=torch.int32)
    tables = torch.zeros(1, ik.TABLE_WORDS, dtype=torch.int32)
    assert torch.equal(ik.inflate_extract(words, seg, seg, seg, tables, 32),
                       torch.zeros(32, 4, dtype=torch.int32))
    for args in (
            (words.long(), seg, seg, seg, tables, 32),
            (words, seg, seg[:3], seg, tables, 32),
            (words, seg, seg, seg, tables[:, :100], 32),
            (words, seg, seg, seg, tables[:0], 32),
            (words[:0], seg, seg, seg, tables, 32),
            (words, seg, seg, seg, tables, 0),
            (words, seg.view(2, 2), seg, seg, tables, 32)):
        with pytest.raises(ZippyError):
            ik.inflate_extract(*args)


def test_table_layout_matches_the_kernel_source():
    src = (port.__file__.rsplit("/ops/", 1)[0] + "/csrc/inflate.cu")
    text = open(src).read()
    assert f"kTableWords = kED + kND;  // {ik.TABLE_WORDS}" in text
    assert f"kFcD = kEL + kNL;     // {ik.FC_D}" in text
    assert f"kOffD = kFcD + 16;    // {ik.OFF_D}" in text
    assert f"kED = kOffD + 16;     // {ik.E_D}" in text

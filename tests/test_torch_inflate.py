"""The port's device decode stages held against zippy_tpu's on the CPU: the
comparison tables, token extraction (K4's plain version) and every tile's
bytes, the reference's jitted `_decode_tile` running on JAX's CPU backend."""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zippy_tpu.ops import inflate_device as ref  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import inflate_device as port  # noqa: E402
from zippy_tpu_torch.ops import inflate_kernels as ik  # noqa: E402
from zippy_tpu_torch.ops import resolve_kernels as rk  # noqa: E402
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
    """The reference's index, tile config, tiles and their packs."""
    index = ref.build_decode_index(blob)
    cfg = ref._pick_cfg(index["total_out"])
    tiles = ref._plan_tiles(index, cfg)
    return index, cfg, tiles, [
        ref._tile_pack(blob, index, tile, cfg,
                       ref._nrounds_for_depth(tile.depth, cfg))
        for tile in tiles]


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
        got = ik._cmp_tables(torch.from_numpy(lens[:, cols].copy()),
                             torch.from_numpy(ent.astype(np.int64)))
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_extract_equals_reference(name):
    """K4's plain version (through the wrapper, on CPU tensors), run over
    all of a stream's tiles as one batch, gives each tile's busy lanes the
    reference's packed tokens exactly; the reference's lanes past them are
    all zero."""
    _, cfg, tiles, packs = _tile_packs(STREAMS[name]())
    words, seg, _, _, lens8 = port._unpack(
        torch.from_numpy(np.stack(packs).view(np.int32)), cfg)
    used = [tile.s1 - tile.s0 for tile in tiles]
    tables = port._block_tables(lens8.reshape(-1, 318))
    got = ik.inflate_extract(words, seg, used, tables, 32)
    assert got.shape == (32, sum(used)) and got.dtype == torch.int32
    col = 0
    for pack, n in zip(packs, used):
        r_words, r_seg, r_lens8 = _ref_extract_inputs(pack, cfg)
        tabs = ref._build_lane_tables(r_lens8, jnp.asarray(r_seg[1]))
        want = np.asarray(ref._extract(r_words, jnp.asarray(r_seg[0]),
                                       jnp.asarray(r_seg[2]), tabs, 32))
        assert not want[:, n:].any()
        assert np.array_equal(want[:, :n], got[:, col:col + n].numpy())
        assert int((want != 0).sum()) == int(r_seg[2].sum())
        col += n


def _decode_tiles_against_reference(blob, want_cfg):
    halo_r = jnp.zeros(HALO, jnp.uint8)
    acc = (jnp.uint32(1), jnp.uint32(0))
    halo_p = torch.zeros(HALO, dtype=torch.uint8)
    ntiles = 0
    _, cfg, tiles, packs = _tile_packs(blob)
    assert cfg == want_cfg
    for tile, pack in zip(tiles, packs):
        out_r, halo_r, *acc = ref._decode_tile(jnp.asarray(pack), halo_r,
                                               *acc, k=32, cfg=cfg)
        out_p = port._decode_tile(_port_pack(pack), halo_p, tile, k=32,
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
    _, *got = rk._ffill(torch.from_numpy(vals != 0),
                          torch.from_numpy(vals), torch.from_numpy(other))
    last = int(np.flatnonzero(flag_at).max())
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w)[:last + 1], g.numpy()[:last + 1])


@functools.cache
def _reference_chain(name):
    """The reference's `_decode_tile` chain over one of STREAMS: per tile,
    the halo handed to it and its output bytes."""
    halo = jnp.zeros(HALO, jnp.uint8)
    acc = (jnp.uint32(1), jnp.uint32(0))
    _, cfg, tiles, packs = _tile_packs(STREAMS[name]())
    chain = []
    for tile, pack in zip(tiles, packs):
        before = np.asarray(halo)
        out, halo, *acc = ref._decode_tile(jnp.asarray(pack), halo, *acc,
                                           k=32, cfg=cfg)
        chain.append((before, np.asarray(out)[HALO:HALO + tile.used]))
    return chain


@pytest.mark.parametrize("cap", [1, 2])
def test_batches_equal_the_reference_chain(cap, monkeypatch):
    """With the batch cap lowered, the decode makes one extraction per
    batch, gives the bytes of the reference's `_decode_tile` chain, and
    hands every tile the reference's halo."""
    monkeypatch.setattr(port, "_TILES_PER_LAUNCH", cap)
    halos, batches = [], []
    resolve, extract = port._resolve, ik.inflate_extract

    def spy_resolve(packed, seg_out, words, stored, halo, *rest):
        halos.append(halo.clone())
        return resolve(packed, seg_out, words, stored, halo, *rest)

    def spy_extract(words, seg, used, *rest):
        batches.append(len(used))
        return extract(words, seg, used, *rest)

    monkeypatch.setattr(port, "_resolve", spy_resolve)
    monkeypatch.setattr(ik, "inflate_extract", spy_extract)
    blob = STREAMS["three_tiles"]()
    buf, _ = port._run_tiles(blob, port.build_decode_index(blob),
                             torch.device("cpu"))
    chain = _reference_chain("three_tiles")
    n = len(chain)
    assert n >= 3 and batches == [min(cap, n - i) for i in range(0, n, cap)]
    assert buf.numpy().tobytes() == b"".join(out.tobytes()
                                             for _, out in chain)
    assert len(halos) == n
    for got, (want, _) in zip(halos, chain):
        assert np.array_equal(got.numpy(), want)


def _code(rng, nsym: int, kind: str) -> np.ndarray:
    """Code lengths of one code: a complete code (random leaves split down
    to length 15 at most), an incomplete one (a complete one with leaves
    dropped), a single length-1 code, none, or random lengths (mostly
    over-subscribed)."""
    lens = np.zeros(nsym, np.uint8)
    if kind == "random":
        return rng.integers(0, 16, nsym).astype(np.uint8)
    if kind == "single":
        lens[rng.integers(nsym)] = 1
        return lens
    if kind == "none":
        return lens
    leaves = [1, 1]
    for _ in range(int(rng.integers(1, nsym - 1))):
        i = int(rng.integers(len(leaves)))
        if leaves[i] < 15:
            leaves[i:i + 1] = [leaves[i] + 1] * 2
    leaves = np.array(leaves[:nsym])
    if kind == "incomplete":
        leaves = leaves[rng.random(leaves.size) < 0.7]
    lens[rng.choice(nsym, leaves.size, replace=False)] = leaves
    return lens


def _random_lens8() -> np.ndarray:
    rng = np.random.default_rng(37)
    kinds = ("complete", "incomplete", "single", "none", "random")
    return np.stack([np.concatenate([_code(rng, 288, a), _code(rng, 30, b)])
                     for a in kinds for b in kinds for _ in range(2)])


def _long_code(r, row, at: int, n: int):
    """K4's decode where its first-level table holds 0: the compares of
    lengths FAST_BITS + 1 .. 14 only, the shorter boundaries taken as
    exceeded. Returns (entry, code length)."""
    lens = torch.arange(ik.FAST_BITS + 1, 15)
    cl = ik.FAST_BITS + 1 + ((r[:, None] >> (15 - lens)) >= row[at + lens]
                             ).sum(dim=1)
    rank = (r >> (15 - cl)) + row[at + 16 + cl]
    inside = (rank >= 0) & (rank < n)
    return torch.where(inside, row[at + 32 + rank.clamp(0, n - 1)], 0), cl


@pytest.mark.parametrize("name", sorted(STREAMS) + ["random_rows"])
def test_fast_table_and_compares_equal_cmp_decode(name):
    """K4's first-level table (`_fast_table_plain`), with the compares of
    the longer lengths where it holds 0, gives the comparison decode's
    entry and code length on every 15-bit window, for every block of the
    streams and for seeded random code lengths (complete, incomplete,
    single-code, empty and over-subscribed codes)."""
    if name == "random_rows":
        lens8 = _random_lens8()
    else:
        lens8 = np.unique(ref.build_decode_index(STREAMS[name]())[
            "block_lens"].astype(np.uint8), axis=0)
    tables = port._block_tables(torch.from_numpy(lens8))
    fast = ik._fast_table_plain(tables)
    assert fast.shape == (len(lens8), 2, 1 << ik.FAST_BITS)
    assert fast.dtype == torch.int32
    r = torch.arange(1 << 15)
    prefix = r >> (15 - ik.FAST_BITS)
    hits = []
    for b, row in enumerate(tables.to(torch.int64)):
        for c, (at, n) in enumerate(((ik.FC_L, ik.LL_SYMS),
                                     (ik.FC_D, ik.D_SYMS))):
            want_e, want_cl = ik._cmp_decode(
                r, row[at:at + 16].expand(r.numel(), 16),
                row[at + 16:at + 32].expand(r.numel(), 16), row, at + 32, n)
            entry = fast[b, c, prefix].to(torch.int64)
            hit = entry != 0
            long_e, long_cl = _long_code(r, row, at, n)
            assert torch.equal(torch.where(hit, entry, long_e), want_e)
            assert torch.equal(torch.where(hit, entry & 15, long_cl),
                               want_cl)
            hits.append(float(hit.double().mean()))
    # The table serves most windows of real codes (every 15-bit window is
    # equally likely here, so a code of length L weighs 2^-L).
    if name != "random_rows":
        assert min(hits[0::2]) > 0.5
    assert 0 < max(hits)


def test_extract_wrapper_checks_its_arguments():
    words = torch.zeros(2, 8, dtype=torch.int32)
    seg = torch.zeros(2, 3, 4, dtype=torch.int32)
    tables = torch.zeros(2, ik.TABLE_WORDS, dtype=torch.int32)
    assert torch.equal(ik.inflate_extract(words, seg, [4, 1], tables, 32),
                       torch.zeros(32, 5, dtype=torch.int32))
    assert ik.inflate_extract(words, seg, [0, 0], tables, 32).shape == (32, 0)
    # Rows may be views into packed buffers.
    packs = torch.zeros(2, 24, dtype=torch.int32)
    assert ik.inflate_extract(packs[:, :8], packs[:, 8:20].unflatten(1, (
        3, 4)), [2, 3], tables, 32).shape == (32, 5)
    for args in (
            (words.long(), seg, [4, 1], tables, 32),
            (words[0], seg, [4, 1], tables, 32),
            (words.t(), seg, [4, 1], tables, 32),
            (words[:, :0], seg, [4, 1], tables, 32),
            (words, seg[:1], [4, 1], tables, 32),
            (words, seg[:, :2], [4, 1], tables, 32),
            (words, seg[:, :, ::2], [2, 1], tables, 32),
            (words, seg, [4], tables, 32),
            (words, seg, [4, 1, 0], tables, 32),
            (words, seg, [5, 1], tables, 32),
            (words, seg, [-1, 1], tables, 32),
            (words, seg, [4, 1], tables[:, :100], 32),
            (words, seg, [4, 1], tables[:0], 32),
            (words, seg, [4, 1], torch.zeros(3, ik.TABLE_WORDS,
                                              dtype=torch.int32), 32),
            (words, seg, [4, 1], torch.zeros(ik.TABLE_WORDS, 2,
                                              dtype=torch.int32).t(), 32),
            (words, seg, [4, 1], tables, 0),
            (words, seg, [4, 1], tables, 1025)):
        with pytest.raises(ZippyError):
            ik.inflate_extract(*args)


def test_table_layout_matches_the_kernel_source():
    src = (port.__file__.rsplit("/ops/", 1)[0] + "/csrc/inflate.cu")
    text = open(src).read()
    assert f"kTableWords = kED + kND;  // {ik.TABLE_WORDS}" in text
    assert f"kFcD = kEL + kNL;     // {ik.FC_D}" in text
    assert f"kOffD = kFcD + 16;    // {ik.OFF_D}" in text
    assert f"kED = kOffD + 16;     // {ik.E_D}" in text
    assert f"kThreads = {ik.LANES_PER_CTA};" in text
    assert f"kFastBits = {ik.FAST_BITS};" in text


# ---------------------------------------------------------------------------
# K9 (block_tables): its plain version against the reference, and a numpy
# model of the kernel's rank scheme
# ---------------------------------------------------------------------------


def _reference_block_tables(lens8: np.ndarray) -> np.ndarray:
    """The reference's `_cmp_tables` of both halves of (rows, 318) records,
    side by side in the port's (rows, 382) layout."""
    lens = lens8.astype(np.int32)
    parts = []
    for cols, ent in ((slice(0, 288), ref._LL_ENT),
                      (slice(288, 318), ref._D_ENT)):
        parts += [np.asarray(x) for x in ref._cmp_tables(
            jnp.asarray(lens[:, cols]), jnp.asarray(ent))]
    return np.concatenate(parts, axis=1)


def _corrupt_lens8() -> dict:
    """Seeded records a corrupt stream could leave: any byte, over-
    subscribed codes (many short lengths), incomplete ones, all zeros."""
    rng = np.random.default_rng(53)
    kinds = ("complete", "incomplete", "single", "none", "random")
    return {
        "bytes above 15": rng.integers(0, 256, (64, 318)).astype(np.uint8),
        "over-subscribed": rng.integers(1, 4, (64, 318)).astype(np.uint8),
        "incomplete and mixed": np.stack([
            np.concatenate([_code(rng, 288, a), _code(rng, 30, b)])
            for a in kinds for b in kinds]),
        "all zero": np.zeros((8, 318), np.uint8),
    }


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_block_tables_equal_reference(name):
    """The `_block_tables` wrapper (K9's plain version on CPU tensors) on
    every block of a stream equals the reference's `_cmp_tables` of both
    halves; a 3-D view into the tiles' packed buffers gives the same rows
    as their records copied out."""
    lens8 = ref.build_decode_index(STREAMS[name]())["block_lens"].astype(
        np.uint8)
    before = dict(ik.LAUNCHES)
    got = port._block_tables(torch.from_numpy(lens8))
    assert ik.LAUNCHES == before          # no launch on the CPU
    assert got.dtype == torch.int32 and got.shape == (len(lens8), 382)
    assert np.array_equal(got.numpy(), _reference_block_tables(lens8))
    _, cfg, _, packs = _tile_packs(STREAMS[name]())
    view = port._unpack(torch.from_numpy(np.stack(packs).view(np.int32)),
                        cfg)[4]
    assert view.dim() == 3 and not view.is_contiguous()
    assert torch.equal(port._block_tables(view),
                       port._block_tables(view.reshape(-1, 318)))


@pytest.mark.parametrize("kind", sorted(_corrupt_lens8()))
def test_block_tables_on_corrupt_records(kind):
    """On corrupt records the plain version equals the reference on the
    records clamped to 0..15, as both the plain version and K9 clamp them
    first (the reference, given a byte above 15, leaves its symbol out of
    the counts but not out of the ranks; no stream the scan passes holds
    one)."""
    lens8 = _corrupt_lens8()[kind]
    got = port._block_tables(torch.from_numpy(lens8)).numpy()
    assert np.array_equal(got, _reference_block_tables(np.minimum(lens8,
                                                                  15)))
    if kind != "bytes above 15":
        assert np.array_equal(got, _reference_block_tables(lens8))


def _k9_code_model(lens: np.ndarray, ent: np.ndarray) -> np.ndarray:
    """K9's CTA on one code of one record, step for step: groups of 32
    symbols, one a lane; a symbol's rank among its group's symbols of its
    length is the lanes of its __match_any_sync group below it, and the
    group's lowest lane writes the group's count of that length; lane b of
    warp 0 sums length b's counts over the groups, keeping each group's
    predecessors; a 16-lane inclusive scan of count[b] << (15 - b) and of
    count[b] (b >= 1) gives first[b] (the exclusive sum shifted back by
    15 - b) and sym_base[b]; each symbol of nonzero length writes its entry
    at its group's base plus its rank, and the slots from the code's total
    on are zeroed by their own lanes. Asserts that every slot of E is
    written exactly once. Returns fc, off, E side by side."""
    S = lens.shape[0]
    ngroups = -(-S // 32)
    cnt = np.zeros((ngroups, 16), np.int64)
    length = np.full(ngroups * 32, 16)
    length[:S] = np.minimum(lens.astype(np.int64), 15)
    rank = np.zeros(ngroups * 32, np.int64)
    for g in range(ngroups):
        lane_len = length[g * 32:(g + 1) * 32]
        for lane, ln in enumerate(lane_len):
            same = [o for o in range(32) if lane_len[o] == ln]
            rank[g * 32 + lane] = sum(1 for o in same if o < lane)
            if ln < 16 and same[0] == lane:
                cnt[g, ln] = len(same)
    count = cnt.sum(axis=0)
    pre = np.cumsum(cnt, axis=0) - cnt                  # (group, length)
    own_f = np.array([int(count[b]) << (15 - b) if b else 0
                      for b in range(16)])
    own_s = np.where(np.arange(16) > 0, count, 0)
    first = (np.cumsum(own_f) - own_f) >> (15 - np.arange(16))
    sym_base = np.cumsum(own_s) - own_s
    total = int(own_s.sum())
    E = np.full(S, -1, np.int64)
    for s in range(S):
        ln = int(length[s])
        if 1 <= ln <= 15:
            pos = sym_base[ln] + pre[s // 32, ln] + rank[s]
            assert E[pos] == -1, "a slot written twice"
            E[pos] = int(ent[s]) | ln
        if s >= total:
            assert E[s] == -1, "a slot written twice"
            E[s] = 0
    assert (E >= 0).all()
    return np.concatenate([first + count, sym_base - first, E])


@pytest.mark.parametrize("kind", ["stream blocks"] + sorted(_corrupt_lens8()))
def test_k9_model_equals_plain(kind):
    if kind == "stream blocks":
        lens8 = np.concatenate([ref.build_decode_index(STREAMS[name]())[
            "block_lens"].astype(np.uint8) for name in sorted(STREAMS)])
    else:
        lens8 = _corrupt_lens8()[kind]
    want = port._block_tables(torch.from_numpy(lens8)).numpy()
    got = np.stack([np.concatenate([
        _k9_code_model(row[:288], ik._LL_ENT),
        _k9_code_model(row[288:], ik._D_ENT)]) for row in lens8])
    assert np.array_equal(got, want)


def test_block_tables_checks_its_arguments():
    lens8 = torch.zeros(4, 318, dtype=torch.uint8)
    assert ik.block_tables(lens8).shape == (4, ik.TABLE_WORDS)
    assert ik.block_tables(lens8[:0]).shape == (0, ik.TABLE_WORDS)
    for bad in (lens8.int(), lens8[:, :317], lens8[0], lens8[None, None],
                lens8.t().contiguous().t(), lens8[:, ::2]):
        with pytest.raises(ZippyError):
            ik.block_tables(bad)
    with pytest.raises(ZippyError, match="unsupported device"):
        ik.block_tables(lens8.to("meta"))


def test_block_tables_kernel_source():
    text = open(port.__file__.rsplit("/ops/", 1)[0]
                + "/csrc/inflate.cu").read()
    assert "int zt_block_tables(" in text
    assert f"kLensPerRow = kNL + kND;  // {ik.LENS_PER_ROW}" in text
    assert "block_tables" in ik.LAUNCHES

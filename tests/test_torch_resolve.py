"""The decode's LZ resolution held against zippy_tpu's on the CPU: the plain
version of kernel K6 (ops/resolve_kernels.py), reached through the
decode's dispatcher `inflate_device._resolve`, against the reference's
`_resolve` jitted on JAX's CPU backend, on synthetic CFG_S tiles made from
seeded numpy data, each also checked against a serial decode of its
tokens; the stored-span tables the packs carry; and the K6 wrapper's
argument checks. Every comparison is exact."""

import functools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zippy_tpu.ops import inflate_device as ref  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import inflate_device as port  # noqa: E402
from zippy_tpu_torch.ops import resolve_kernels as rk  # noqa: E402
from _torch_parity import one_thread  # noqa: E402,F401
from test_torch_inflate import STREAMS  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")

HALO = rk.HALO
STO_MAX = rk.STO_MAX
CFG = port.CFG_S
OUT_PAD = HALO + CFG.tile_out
K = 32


class Tile:
    """A synthetic tile from a list of entities in output order: ("lit",
    byte), ("match", length, distance) and ("stored", source byte in the
    words, length). Tokens fill segment lanes of up to K; a stored span
    ends its lane. Holds the resolve's inputs as the decode forms them and
    `want`, the serial decode of halo + entities (out[:HALO + used])."""

    def __init__(self, entities, halo: np.ndarray, words: np.ndarray):
        out = bytearray(halo.tobytes())
        wbytes = words.view(np.uint8)
        lanes, lane, stored = [], None, []
        for e in entities:
            pos = len(out)
            if e[0] == "stored":
                _, src, n = e
                chunk = wbytes[src:src + n].tobytes()
                out += chunk + bytes(n - len(chunk))
                stored.append((src, pos, n))
                lane = None
                continue
            if lane is None or len(lane[1]) == K:
                lane = (pos, [])
                lanes.append(lane)
            if e[0] == "lit":
                lane[1].append((1 << 16) | e[1])
                out.append(e[1])
            else:
                _, n, d = e
                lane[1].append((n << 16) | (d + 256))
                for o in range(n):
                    out.append(out[pos + o - d])
        self.used = len(out) - HALO
        # Within the tile's capacities, as the planner cuts tiles.
        assert self.used <= CFG.tile_out and len(lanes) <= CFG.nseg
        assert len(stored) <= CFG.nsto
        assert sum(e[1] for e in entities if e[0] == "match") <= CFG.ncmp
        self.want = bytes(out)
        self.halo, self.words, self.stored = halo, words, stored
        self.packed = np.zeros((K, len(lanes)), np.int32)
        self.seg_out = np.array([p for p, _ in lanes], np.int32)
        for c, (_, toks) in enumerate(lanes):
            self.packed[:len(toks), c] = toks
        self.sto = np.zeros((3, CFG.nsto), np.int32)
        self.sto[1] = OUT_PAD
        if stored:
            self.sto[:, :len(stored)] = np.array(stored, np.int32).T

    def port_args(self):
        """The dispatcher's arguments, as `_decode_batch` gives them."""
        t = torch.from_numpy
        return (t(self.packed), t(self.seg_out), t(self.words), t(self.sto),
                t(self.halo), self.used)


@functools.cache
def _ref_resolve():
    return jax.jit(ref._resolve, static_argnames=("cfg",))


def _reference(tile, nrounds: int) -> np.ndarray:
    """The reference's `_resolve` on the tile, its lanes padded to nseg as
    its packs lay them out."""
    n = tile.packed.shape[1]
    packed = np.zeros((K, CFG.nseg), np.int32)
    packed[:, :n] = tile.packed
    seg_out = np.full(CFG.nseg, OUT_PAD, np.int32)
    seg_out[:n] = tile.seg_out
    return np.asarray(_ref_resolve()(
        jnp.asarray(packed), jnp.asarray(seg_out),
        jnp.asarray(tile.words.view(np.uint32)), *map(jnp.asarray, tile.sto),
        jnp.asarray(tile.halo), jnp.int32(nrounds), cfg=CFG))


def _rng(seed: int):
    return np.random.default_rng(seed)


def _halo(seed: int) -> np.ndarray:
    return _rng(seed).integers(0, 256, HALO, dtype=np.uint8)


def _words(seed: int) -> np.ndarray:
    return _rng(seed).integers(-2**31, 2**31, CFG.nwords, dtype=np.int64
                               ).astype(np.int32)


def _mixed(rng, n: int, max_back: int):
    """n random literals and matches (lengths 3..258, distances 1..32768
    within the `max_back` bytes before each)."""
    out, back = [], max_back
    for _ in range(n):
        if rng.random() < 0.4:
            out.append(("lit", int(rng.integers(256))))
            back += 1
        else:
            ln = int(rng.integers(3, 259))
            out.append(("match", ln, int(rng.integers(1, min(back, HALO)
                                                      + 1))))
            back += ln
    return out


def _overlap_tile() -> Tile:
    """Matches with d < len: d = 1 runs of 258 and shorter, d = 2, 3 and 7
    over long lengths, among random literals and matches."""
    rng = _rng(71)
    ents = [("lit", int(b)) for b in rng.integers(0, 256, 8)]
    ents += [("match", 258, 1), ("lit", 7), ("match", 200, 2),
             ("match", 100, 7), ("match", 3, 1), ("match", 258, 3)]
    for _ in range(150):
        ents += _mixed(rng, 5, 600)
        d = int(rng.integers(1, 9))
        ents.append(("match", int(rng.integers(d + 1, 259)), d))
    return Tile(ents, np.zeros(HALO, np.uint8), _words(72))


def _halo_tile() -> Tile:
    """Matches into the halo, from the tile's first byte on (up to 32768
    back), mixed with matches inside the tile."""
    rng = _rng(73)
    ents = [("match", 258, HALO), ("match", 40, 100), ("lit", 1),
            ("match", 3, HALO), ("match", 258, 5000)]
    ents += _mixed(rng, 1200, HALO)
    return Tile(ents, _halo(74), _words(75))


def _stored_tile() -> Tile:
    """Stored spans at the tile's start, in its middle (one of 65535
    bytes) and at its end, one cut short by the words (its source runs
    past the last word), and matches that read stored bytes."""
    rng = _rng(76)
    nbytes = 4 * CFG.nwords
    ents = [("stored", 1000, 5000)]
    ents += [("match", 258, 4000), ("match", 30, 1)]
    ents += _mixed(rng, 300, 5000)
    ents += [("stored", 20000, 65535), ("match", 258, 30000)]
    ents += _mixed(rng, 300, HALO)
    ents += [("stored", nbytes - 700, 3000), ("match", 100, 2900)]
    ents += _mixed(rng, 50, HALO)
    ents += [("stored", 123, 4567)]
    return Tile(ents, _halo(77), _words(78))


def _deep_tile() -> Tile:
    """One chain across 43,000 tokens: three literals, then matches of
    length 3 at distance 3, each reading the one before it. Resolving it
    takes 16 doubling rounds; the cap for CFG_S is 17."""
    ents = [("lit", 97), ("lit", 98), ("lit", 99)]
    ents += [("match", 3, 3)] * 43000
    return Tile(ents, np.zeros(HALO, np.uint8), _words(79))


def _small_tile() -> Tile:
    """A tile of about 1,000 bytes (used < HALO) whose matches read the
    halo: the next halo is mostly the halo it was given."""
    rng = _rng(80)
    ents, used = [("match", 50, 30000)], 50
    while used < 1000:
        if rng.random() < 0.5:
            ents.append(("lit", int(rng.integers(256))))
            used += 1
        else:
            ln = int(rng.integers(3, 40))
            ents.append(("match", ln, int(rng.integers(1, HALO + 1))))
            used += ln
    return Tile(ents, _halo(81), _words(82))


def _empty_tile() -> Tile:
    return Tile([], _halo(83), _words(84))


TILES = {"overlap": _overlap_tile, "halo": _halo_tile,
         "stored": _stored_tile, "deep": _deep_tile, "small": _small_tile,
         "empty": _empty_tile}
CAP = port._nrounds_for_depth(0xFFFF, CFG)


@pytest.mark.parametrize("name", sorted(TILES))
def test_resolve_equals_reference(name):
    """The dispatcher, on CPU tensors, gives the reference's `_resolve`
    output, all of it, and its first HALO + used bytes are the serial
    decode, with as many rounds as the tile's chains need."""
    tile = TILES[name]()
    nrounds = CAP
    got = port._resolve(*tile.port_args(), nrounds, CFG)
    assert got.dtype == torch.uint8 and got.shape == (OUT_PAD,)
    assert np.array_equal(got.numpy(), _reference(tile, nrounds))
    n = HALO + tile.used
    assert got.numpy()[:n].tobytes() == tile.want
    if name == "small":
        assert tile.used < HALO
        assert np.array_equal(got.numpy()[tile.used:tile.used + HALO][
            :HALO - tile.used], tile.halo[tile.used:])
    if name == "empty":
        assert tile.used == 0 and tile.packed.shape[1] == 0
        assert np.array_equal(got.numpy()[:HALO], tile.halo)


def test_deep_chain_needs_many_rounds():
    """With too few rounds the deep chain is left unresolved, and the two
    versions still agree byte for byte: they run the same rounds."""
    tile = _deep_tile()
    assert CAP == 17
    got = port._resolve(*tile.port_args(), 12, CFG)
    assert got.numpy()[:HALO + tile.used].tobytes() != tile.want
    assert np.array_equal(got.numpy(), _reference(tile, 12))


def test_tokens_past_used_change_no_byte_a_caller_reads():
    """A corrupt tile: its first lane's tokens decode 8,000 bytes where the
    tile holds 1,000 (`used`), and its second lane starts past them. The
    dispatcher still gives the reference's output, and out[:HALO + used]
    is the literal's run the first lane starts with: bytes past `used` are
    padding, which K6 never writes (chip_smoke.py holds it to that)."""
    used = 1000
    tile = types.SimpleNamespace(
        packed=np.zeros((K, 2), np.int32),
        seg_out=np.array([HALO, HALO + used + 5000], np.int32),
        words=_words(85), sto=np.zeros((3, CFG.nsto), np.int32),
        halo=_halo(86), used=used)
    tile.packed[0, 0] = (1 << 16) | 0x41
    tile.packed[1:, 0] = (258 << 16) | (1 + 256)
    tile.packed[:, 1] = (1 << 16) | 0x42
    tile.sto[1] = OUT_PAD
    got = port._resolve(*Tile.port_args(tile), CAP, CFG).numpy()
    assert np.array_equal(got, _reference(tile, CAP))
    assert np.array_equal(got[:HALO], tile.halo)
    assert got[HALO:HALO + used].tobytes() == b"A" * used


def _tile_stored(index, tile) -> list:
    """The tile's stored spans from the index, relative to the tile: (source
    byte in its words, output position, length)."""
    sto = index["stored"]
    sto = sto[sto[:, 2] > 0] if sto.shape[0] else sto
    return [(int(s) - tile.w0 * 4, int(o) - tile.base + HALO, int(n))
            for s, o, n in sto[tile.t0:tile.t1]]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_unpacked_stored_table_equals_tile_stored(name):
    """The stored-span table `_unpack` returns for each tile, read as
    (source, output, length), is the index's spans relative to the tile
    (`_tile_stored`); its empty slots are (0, out_pad, 0)."""
    blob = STREAMS[name]()
    index = port.build_decode_index(blob)
    cfg = port._pick_cfg(index["total_out"])
    tiles = port._plan_tiles(index, cfg)
    packs = [port._tile_pack(blob, index, t, cfg, 1) for t in tiles]
    _, _, _, sto, _ = port._unpack(
        torch.from_numpy(np.stack(packs).view(np.int32)), cfg)
    assert sto.shape == (len(tiles), 3, cfg.nsto) and sto.dtype == torch.int32
    spans = 0
    for tile, table in zip(tiles, sto):
        want = _tile_stored(index, tile)
        rows = [tuple(r) for r in table.T.tolist()]
        assert rows[:len(want)] == want
        assert rows[len(want):] == [(0, HALO + cfg.tile_out, 0)] * (
            cfg.nsto - len(want))
        assert rk.stored_spans(table) == want
        spans += len(want)
    assert spans or name != "stored_and_literals"


def test_dispatcher_runs_the_plain_version_on_cpu(monkeypatch):
    """On CPU tensors the dispatcher runs the plain version, with the spans
    read from the table as host ints, and loads and counts no kernel."""
    tile = _stored_tile()
    calls = []
    plain = rk._resolve_plain

    def spy(packed, seg_out, words, stored, *rest):
        calls.append(stored)
        return plain(packed, seg_out, words, stored, *rest)

    def no_kernel():
        raise AssertionError("the kernel was loaded")

    monkeypatch.setattr(rk, "_resolve_plain", spy)
    monkeypatch.setattr(rk, "_lib", no_kernel)
    before = dict(rk.LAUNCHES)
    got = port._resolve(*tile.port_args(), 12, CFG)
    assert calls == [tile.stored] and rk.LAUNCHES == before
    assert got.numpy()[:HALO + tile.used].tobytes() == tile.want


def test_decode_resolves_through_the_dispatcher(monkeypatch):
    """A whole decode on the CPU resolves each tile through `_resolve`,
    with the tile's stored-span table and `used`."""
    seen = []
    dispatch = port._resolve

    def spy(packed, seg_out, words, sto, halo, used, *rest):
        seen.append((rk.stored_spans(sto), used))
        return dispatch(packed, seg_out, words, sto, halo, used, *rest)

    monkeypatch.setattr(port, "_resolve", spy)
    blob = STREAMS["stored_and_literals"]()
    index = port.build_decode_index(blob)
    tiles = port._plan_tiles(index, port._pick_cfg(index["total_out"]))
    buf, _ = port._run_tiles(blob, index, torch.device("cpu"))
    assert seen == [(_tile_stored(index, t), t.used) for t in tiles]
    assert sum(len(spans) for spans, _ in seen)
    assert int(buf.shape[0]) == index["total_out"]


def test_lz_resolve_checks_its_arguments():
    tile = _small_tile()
    packed, seg_out, words, sto, halo, used = tile.port_args()
    assert rk.lz_resolve(packed, seg_out, words, sto, halo, used, 3,
                         CFG).shape == (OUT_PAD,)
    lanes = packed.shape[1]
    for args in (
            (packed.long(), seg_out, words, sto, halo, used, 3),
            (packed[0], seg_out, words, sto, halo, used, 3),
            (packed.t(), seg_out, words, sto, halo, used, 3),
            (packed[:0], seg_out[:0], words, sto, halo, used, 3),
            (packed, seg_out[:lanes - 1], words, sto, halo, used, 3),
            (packed, seg_out.long(), words, sto, halo, used, 3),
            (packed, seg_out, words.view(torch.uint8), sto, halo, used, 3),
            (packed, seg_out, words[:0], sto, halo, used, 3),
            (packed, seg_out, words, sto[:2], halo, used, 3),
            (packed, seg_out, words, sto[:, :0], halo, used, 3),
            (packed, seg_out, words, sto.t().contiguous().t(), halo, used,
             3),
            (packed, seg_out, words, sto, halo[1:], used, 3),
            (packed, seg_out, words, sto, halo.int(), used, 3),
            (packed, seg_out, words, sto, halo, -1, 3),
            (packed, seg_out, words, sto, halo, CFG.tile_out + 1, 3),
            (packed, seg_out, words, sto, halo, used, -1),
            (packed, seg_out, words, sto, halo, used, 65)):
        with pytest.raises(ZippyError):
            rk.lz_resolve(*args, CFG)


def _cu_int(text: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return int(eval(m.group(1), {}))


def _kernel_source() -> str:
    return open(rk.__file__.rsplit("/ops/", 1)[0] + "/csrc/resolve.cu").read()


def test_launch_budget_and_kernel_source():
    """K6 launches an expansion and rounds_for(nrounds, hops) rounds a tile,
    within nrounds + 3; its source has the wrapper's constants."""
    cap_l = port._nrounds_for_depth(0xFFFF, port.CFG_L)
    for used in (0, 1000, CFG.tile_out, CFG.tile_out + 1,
                 port.CFG_L.tile_out):
        for n in range(cap_l + 1):
            assert rk.launches_per_tile(n, used) <= n + 3
    assert rk.launches_per_tile(0, 1000) == 2
    assert rk.launches_per_tile(6, 16399) == 3
    assert rk.launches_per_tile(7, 164504) == 4
    assert rk.launches_per_tile(8, 2835774) == 5
    text = _kernel_source()
    assert _cu_int(text, "kHalo") == HALO
    assert _cu_int(text, "kStoMax") == rk.STO_MAX == 1 << 16
    assert _cu_int(text, "kSmallTile") == rk.SMALL_TILE
    assert _cu_int(text, "kSmallHops") == rk.SMALL_HOPS
    assert _cu_int(text, "kLargeHops") == rk.LARGE_HOPS
    assert "const int b = hops >= 7 ? 3 : hops >= 3 ? 2 : 1;" in text
    assert "return nrounds > 0 ? (nrounds + b - 1) / b : 1;" in text
    assert "lz_resolve" in rk.LAUNCHES


def test_round_shapes_reach_the_plain_rounds():
    """Every CFG_S tile takes the small round shape (SMALL_HOPS hops a
    round), a larger CFG_L tile the large one; and for every nrounds up to
    CFG_L's cap, rounds_for's rounds of h hops reach (h + 1)^rounds hops
    down a chain, at least the plain version's 2^nrounds."""
    assert rk.hops_per_round(CFG.tile_out) == rk.SMALL_HOPS == 7
    assert rk.hops_per_round(0) == rk.SMALL_HOPS
    assert rk.hops_per_round(CFG.tile_out + 1) == rk.LARGE_HOPS == 3
    assert rk.SMALL_TILE == CFG.tile_out
    for hops in (1, 3, 7):
        for n in range(port._nrounds_for_depth(0xFFFF, port.CFG_L) + 1):
            rounds = rk.rounds_for(n, hops)
            assert rounds >= 1 and (hops + 1) ** rounds >= 2 ** n
            assert (hops + 1) ** (rounds - 1) < 2 ** n or n == 0


def _k6_model(packed, seg_out, words, sto, halo, used: int, nrounds: int,
              cfg, hops: int) -> torch.Tensor:
    """K6's algorithm step for step on the CPU (csrc/resolve.cu), under the
    slowest schedule its kernels allow: each hop of a round reads the
    states as the round found them. The expansion writes each covered tile
    byte's int32 state (~value for a literal, a stored byte or a distance
    of 0; a match byte's link, start - d + (o mod d) clamped) and the
    literals' and stored bytes' values; then rounds_for(nrounds, hops)
    rounds, each taking `hops` hops an open byte (0 when nrounds is 0), the
    last finishing with one more lookup and out[0]'s value for a byte still
    open. Returns out[:HALO + used]; every tile byte must be covered."""
    out_pad = HALO + cfg.tile_out
    unset = 1 << 30  # no token or span covered the byte
    out = torch.zeros(out_pad, dtype=torch.int64)
    out[:HALO] = halo.to(torch.int64)
    state = torch.full((used,), unset, dtype=torch.int64)
    tok = packed.T.to(torch.int64)
    length, low = tok >> 16, tok & 0xFFFF
    start = seg_out.to(torch.int64)[:, None] + torch.cumsum(length, 1) - length
    length, low, start = length.reshape(-1), low.reshape(-1), start.reshape(-1)
    o = torch.arange(int(length.sum())) - torch.repeat_interleave(
        torch.cumsum(length, 0) - length, length)
    low_b = torch.repeat_interleave(low, length)
    start_b = torch.repeat_interleave(start, length)
    pos = start_b + o
    inside = (pos >= HALO) & (pos < HALO + used)
    d = (low_b - 256).clamp(min=1)
    link = (start_b - d + o % d).clamp(0, out_pad - 1)
    s = torch.where(low_b < 256, ~low_b, torch.where(low_b > 256, link, ~0))
    state[pos[inside] - HALO] = s[inside]
    lit = inside & (low_b <= 256)
    out[pos[lit]] = torch.where(low_b[lit] < 256, low_b[lit], 0)
    nbytes = words.numel() * 4
    wbytes = words.contiguous().view(torch.uint8).to(torch.int64)
    for src, o0, ln in rk.stored_spans(sto):
        src = min(max(src, 0), nbytes)
        o0 = min(max(o0, 0), out_pad)
        ln = max(0, min(ln, STO_MAX, out_pad - o0))
        n = min(ln, nbytes - src)
        b = torch.cat([wbytes[src:src + n], torch.zeros(ln - n, dtype=torch.int64)])
        p = torch.arange(o0, o0 + ln)
        out[p[p < HALO + used]] = b[p < HALO + used]
        keep = (p >= HALO) & (p < HALO + used)
        state[p[keep] - HALO] = ~b[keep]
    assert not (state == unset).any(), "a tile byte no token covered"

    j = torch.arange(used)
    zero = ~out[0]

    def look(snap, p):
        q = snap[(p - HALO).clamp(0, max(used - 1, 0))] if used else p
        q = torch.where(q >= p, ~torch.zeros_like(q), q)
        return torch.where(p < HALO, ~out[p.clamp(max=HALO - 1)], q)

    for r in range(rk.rounds_for(nrounds, hops)):
        snap = state.clone()
        is_open = (state >= 0) & (state < HALO + j)
        s = state.clone()
        for _ in range(hops if nrounds > 0 else 0):
            s = torch.where(is_open & (s >= 0), look(snap, s.clamp(min=0)), s)
        if r == rk.rounds_for(nrounds, hops) - 1:
            v = look(snap, s.clamp(min=0))
            s = torch.where(is_open & (s >= 0),
                            torch.where(v < 0, v, zero), s)
        state = torch.where(is_open, s, state)
        done = is_open & (state < 0)
        out[HALO + j[done]] = ~state[done]
    return out[:HALO + used].to(torch.uint8)


def _corrupt_tile():
    """The corrupt tile of test_tokens_past_used_change_no_byte_a_caller_reads
    as a Tile-like namespace."""
    used = 1000
    tile = types.SimpleNamespace(
        packed=np.zeros((K, 2), np.int32),
        seg_out=np.array([HALO, HALO + used + 5000], np.int32),
        words=_words(85), sto=np.zeros((3, CFG.nsto), np.int32),
        halo=_halo(86), used=used)
    tile.packed[0, 0] = (1 << 16) | 0x41
    tile.packed[1:, 0] = (258 << 16) | (1 + 256)
    tile.packed[:, 1] = (1 << 16) | 0x42
    tile.sto[1] = OUT_PAD
    return tile


@pytest.mark.parametrize("hops", [rk.LARGE_HOPS, rk.SMALL_HOPS])
@pytest.mark.parametrize("name", sorted(TILES) + ["corrupt"])
def test_k6_model_equals_plain(name, hops):
    """The step-for-step model of K6's expansion and rounds, with either
    round shape, gives the plain version's out[:HALO + used] on every
    synthetic tile, the 43,000-token chain at CFG_S's 17-round cap and the
    corrupt tile whose tokens run past `used` included."""
    tile = _corrupt_tile() if name == "corrupt" else TILES[name]()
    args = Tile.port_args(tile)
    n = HALO + tile.used
    want = rk._resolve_plain(*args[:3], rk.stored_spans(args[3]), args[4],
                             CAP, CFG)[:n]
    got = _k6_model(*args, CAP, CFG, hops)
    assert torch.equal(got, want)

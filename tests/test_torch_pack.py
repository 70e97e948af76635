"""K8's plain version (pack_kernels.pack_tokens_plain, reached through the
wrapper on CPU tensors) held against zippy_tpu's pack_tokens, jitted on
JAX's CPU backend, and a step-for-step numpy model of K8's threads (their
masks by the vector or the scalar path, their predicated loads of the
fields' low words), chunks, scan, look-back, word ownership and tail
zeroing held against the plain version. Words are int32 bit patterns of
the reference's uint32 words, compared exactly.

The token covers come from the port's find_tokens on 4 KiB blocks; the
tables from its huffman_tables (K5's plain version), or the fixed ones,
or 15-bit lengths for every used symbol."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke as cs  # noqa: E402
from _torch_parity import mixed_payload, one_thread, random_bytes  # noqa: E402,F401
from zippy_tpu.ops import deflate_device as jd  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402
from zippy_tpu_torch.ops import kernel_build as kb  # noqa: E402
from zippy_tpu_torch.ops import pack_kernels as pk  # noqa: E402
from zippy_tpu_torch.ops.device_tables import const  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")

BLOCK = 4096
SOURCE = pathlib.Path(pk.__file__).resolve().parent.parent / "csrc" / "pack.cu"
# csrc/pack.cu's matches a lane loads in one round.
MATCH_BATCH = int(re.search(r"constexpr int kMatchBatch = (\d+);",
                            SOURCE.read_text()).group(1))
FIXED = ("fixed_ll", "fixed_ll_codes", "fixed_d", "fixed_d_codes")


def _rows(kind: str, nrows: int = 3, n=BLOCK) -> np.ndarray:
    """(nrows, HIST + n + PAD) uint8 rows of one kind, history real."""
    width = td.HIST + n + td.PAD
    if kind == "text":
        src = mixed_payload(width * nrows, 41)
    elif kind == "random":
        src = random_bytes(width * nrows, 42)
    else:
        src = bytes(width * nrows)
    return np.frombuffer(src, np.uint8).reshape(nrows, width).copy()


def _cover(kind: str, level: int, n=BLOCK):
    """The port's token cover of _rows(kind) at `level` (-2: literals
    only), and its K5 tables (use_ll, ll_codes, use_d, d_codes, mode)."""
    rows = torch.from_numpy(_rows(kind, n=n))
    k, lazy, min3 = td._level_params(1 if level == -2 else level)
    nn = torch.full((rows.shape[0],), n, dtype=torch.int64)
    tok = td.find_tokens(rows, nn, td.HIST, k=k, lazy=lazy, hist=td.HIST,
                         min3=min3, lits_only=level == -2)
    tab = td.huffman_tables_plain(tok["ll_hist"], tok["dist_hist"], nn)
    return tok, [tab[key] for key in ("use_ll", "ll_codes", "use_d",
                                      "d_codes")], tab["mode"]


def _fixed(rows: int):
    return [const(name, torch.device("cpu"))[None].expand(rows, -1)
            for name in FIXED]


def _fifteen(tables, seed: int):
    """Every used symbol at 15 bits, random 15-bit codes: the most bits a
    table can cost."""
    rng = np.random.default_rng(seed)
    out = []
    for lens, _ in (tables[:2], tables[2:]):
        out.append(torch.where(lens > 0, 15, 0))
        out.append(torch.from_numpy(rng.integers(0, 1 << 15, tuple(
            lens.shape), dtype=np.int64)))
    return out


def _reference(tok, tables):
    """zippy_tpu's pack_tokens, jitted, a row at a time: (words, bits)."""
    keys = ("is_tok", "is_match", "sym", "len_idx", "dist_idx", "length",
            "dist")
    words, bits = [], []
    for r in range(tok["is_tok"].shape[0]):
        row = {key: jnp.asarray(tok[key][r].numpy().astype(
            bool if tok[key].dtype == torch.bool else np.int32))
            for key in keys}
        w, b = jd.pack_tokens(row, *(jnp.asarray(t[r].numpy().astype(
            np.int32)) for t in tables))
        words.append(np.asarray(w).astype(np.uint32).view(np.int32))
        bits.append(int(b))
    return np.stack(words), np.array(bits)


CASES = {
    "L1": ("text", 1, None),
    "L6": ("text", 6, None),
    "L9": ("text", 9, None),
    "L-2": ("text", -2, None),
    "fixed tables": ("text", 6, "fixed"),
    "stored row": ("random", 6, None),
    "15-bit codes": ("text", 6, "fifteen"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_equals_reference(case):
    kind, level, tables_kind = CASES[case]
    tok, tables, mode = _cover(kind, level)
    if tables_kind == "fixed":
        tables = _fixed(tables[0].shape[0])
    elif tables_kind == "fifteen":
        tables = _fifteen(tables, 7)
    if case == "stored row":
        assert (mode == 0).all()
    before = dict(kb.LAUNCHES)
    words, bits = td.pack_tokens(tok, *tables)
    assert kb.LAUNCHES == before          # no launch on the CPU
    assert words.dtype == torch.int32 and bits.dtype == torch.int64
    assert words.shape == (tok["is_tok"].shape[0], BLOCK // 2 + 8)
    want_words, want_bits = _reference(tok, tables)
    assert np.array_equal(bits.numpy(), want_bits)
    assert np.array_equal(words.numpy(), want_words)


# ---------------------------------------------------------------------------
# A numpy model of K8, step for step
# ---------------------------------------------------------------------------


FIELDS = ("sym", "len_idx", "dist_idx", "length", "dist")


def _i32(v) -> int:
    """The low 32 bits of an int64 value as an int32, as K8 loads it."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def _clamp(v: int, hi: int) -> int:
    return 0 if v < 0 else min(v, hi)


class _Loads:
    """K8's reads of the token cover, flat over (G, N), a chunk at a time.
    The owners' masks: each thread's 16 positions' bools by two 16-byte
    vector loads where they lie in the row and are 16-byte aligned, else a
    byte at a time. At K8's shape (threads a multiple of 32, 16 positions a
    thread), the fields are loaded by lanes: lane l of warp w loads the
    chunk positions 512 w + 32 k + l, its bit k taken from owner 2 k + l //
    16 of its warp, bit l % 16 (the kernel's shuffle): the low word of
    `sym` at its tokens, and of the four match fields at its matches,
    MATCH_BATCH a round. At other shapes each thread loads its own. Keeps
    the flat positions each field was read at, the paths the masks took and
    the most rounds a lane took."""

    def __init__(self, tok):
        self.f = {key: tok[key].reshape(-1).numpy() for key in (
            "is_tok", "is_match", *FIELDS)}
        self.read = {key: set() for key in FIELDS}
        self.paths = {"vector": 0, "scalar": 0}
        self.rounds = 0

    def _load(self, key: str, p: int) -> int:
        self.read[key].add(p)
        return _i32(self.f[key][p])

    def chunk(self, cb: int, left: int, threads: int, per: int) -> list:
        """(token bit, match bit, low words) of each of the chunk's
        threads * per positions, flat from cb; positions at or past `left`
        are none of the row's."""
        tm, mm = [0] * threads, [0] * threads
        for i in range(threads):
            p0, rem = cb + i * per, left - i * per
            vector = per == 16 and rem >= per and p0 % 16 == 0
            self.paths["vector" if vector else "scalar"] += rem > 0
            for j in range(min(per, max(rem, 0))):
                tm[i] |= int(self.f["is_tok"][p0 + j] != 0) << j
                mm[i] |= int(self.f["is_match"][p0 + j] != 0) << j
        out = [[tm[q // per] >> (q % per) & 1, mm[q // per] >> (q % per) & 1,
                {}] for q in range(threads * per)]
        if per == 16 and threads % 32 == 0:
            for w in range(threads // 32):
                for lane in range(32):
                    qs = [512 * w + 32 * k + lane for k in range(16)]
                    owner = [32 * w + 2 * k + lane // 16 for k in range(16)]
                    lt = sum((tm[o] >> lane % 16 & 1) << k
                             for k, o in enumerate(owner))
                    lm = sum((mm[o] >> lane % 16 & 1) << k
                             for k, o in enumerate(owner))
                    for k, q in enumerate(qs):
                        assert (lt >> k & 1, lm >> k & 1) == tuple(out[q][:2])
                        if lt >> k & 1:
                            out[q][2]["sym"] = self._load("sym", cb + q)
                    ks = [k for k in range(16) if lm >> k & 1]
                    self.rounds = max(self.rounds,
                                      -(-len(ks) // MATCH_BATCH))
                    for k in ks:
                        for key in FIELDS[1:]:
                            out[qs[k]][2][key] = self._load(key, cb + qs[k])
        else:
            for q, (t, m, lo) in enumerate(out):
                for key in FIELDS:
                    if (t if key == "sym" else m):
                        lo[key] = self._load(key, cb + q)
        return [tuple(e) for e in out]


def _code(entry, tables, r: int, cons) -> tuple:
    """A position's whole code (value, length) in row r from its loads,
    the four components concatenated as K8 builds them."""
    t, m, lo = entry
    ll_l, ll_c, d_l, d_c = (x[r] for x in tables)
    c = n = 0
    if t:
        s = _clamp(lo["sym"], 285)
        n = int(ll_l[s]) & 15
        c = int(ll_c[s]) & 0xFFFF if n else 0
    if m:
        li, di = _clamp(lo["len_idx"], 28), _clamp(lo["dist_idx"], 29)
        dn = int(d_l[di]) & 15
        parts = ((lo["length"] - int(cons["base_len"][li]),
                  int(cons["len_extra"][li])),
                 (int(d_c[di]) & 0xFFFF if dn else 0, dn),
                 (lo["dist"] - int(cons["base_dist"][di]),
                  int(cons["dist_extra"][di])))
        for v, k in parts:
            c |= (v & ((1 << k) - 1)) << n
            n += k
    return c, n


def _combine(a, b):
    """(count, tail) of a then b."""
    t = b[1] if b[0] >= 32 else ((a[1] >> b[0]) | b[1])
    return a[0] + b[0], t


def _append(run, c, m):
    """Run after appending an m-bit code, in <= 32-bit parts."""
    n, t = run
    for v, k in ((c & 0xFFFFFFFF, min(m, 32)), (c >> 32, max(m - 32, 0))):
        t = (((v & 0xFFFFFFFF) << 32) | t) >> k & 0xFFFFFFFF
        n += k
    return n, t


def k8_model(tok, tables, threads: int, per: int, seen=None, loads=None):
    """K8's scheme on CPU arrays: chunks of threads * per positions, a
    chunk's loads (_Loads: the owners' masks, the lanes' loads), each
    position's code as its lane stages it for its owner, an owner's
    (count, tail) run over its per positions, the CTA's exclusive
    scan, each chunk's prefix from the aggregates of the chunks before it in
    the order the look-back combines them (back to the nearest inclusive
    prefix), each thread's accumulator writing the words whose last bit is
    its own, and the last chunk zeroing the rest of the row: a scalar head
    to a 16-byte boundary, 16-byte stores, a scalar tail (the words' base
    16-byte aligned, as torch allocates it). Asserts that no word is written
    twice; `seen` collects the chunks' (first bit, bit count). Returns the
    words as int32 bit patterns and the bit counts."""
    G, N = tok["is_tok"].shape
    wn = pk.words_per_row(N)
    chunk = threads * per
    nchunks = -(-N // chunk)
    words = np.full((G, wn), -1, np.int64)
    total = np.zeros(G, np.int64)
    rng = np.random.default_rng(11)
    loads = loads if loads is not None else _Loads(tok)
    cons = {name: const(name, torch.device("cpu")).numpy() for name in (
        "len_extra", "base_len", "dist_extra", "base_dist")}
    tabs = [t.numpy() for t in tables]
    for r in range(G):
        codes = []
        for ci in range(nchunks):
            codes += [_code(e, tabs, r, cons) for e in loads.chunk(
                r * N + ci * chunk, N - ci * chunk, threads, per)]
        runs = []
        for q0 in range(0, nchunks * chunk, per):
            run = (0, 0)
            for c, m in codes[q0:q0 + per]:
                run = _append(run, c, m)
            runs.append(run)
        aggs, prefixes = [], []
        for ci in range(nchunks):
            agg = (0, 0)
            for run in runs[ci * threads:(ci + 1) * threads]:
                agg = _combine(agg, run)
            aggs.append(agg)
            # The look-back meets the nearest chunk j whose inclusive prefix
            # is out (any of them, as the CTAs' timing has it) and combines
            # the aggregates after it.
            prefix = (0, 0)
            if ci:
                j = int(rng.integers(0, ci))
                prefix = _fold(prefixes[j], aggs[j + 1:ci])
                assert prefix == _fold((0, 0), aggs[:ci])
            prefixes.append(_combine(prefix, agg))
            if seen is not None:
                seen.append((prefix[0], agg[0]))
            excl = (0, 0)
            for i in range(threads):
                start = _combine(prefix, excl)
                _emit(words[r], codes, (ci * threads + i) * per, per,
                      start, wn)
                excl = _combine(excl, runs[ci * threads + i])
        # The last thread of the last chunk: the end-of-block code, the
        # last partial word; then the CTA zeroes the rest.
        end = prefixes[-1]
        eob = (int(tabs[1][r, 256]) & 0xFFFF if int(tabs[0][r, 256]) & 15
               else 0, int(tabs[0][r, 256]) & 15)
        w = _emit(words[r], [eob], 0, 1, end, wn, final=True)
        total[r] = end[0] + eob[1]
        _zero_tail(words[r], min(w, wn), (r * wn * 4) % 16)
    assert (words >= 0).all()
    return words.astype(np.uint32).view(np.int32), total


def _zero_tail(row, start: int, base_mod16: int):
    """The last chunk's zeroing of row[start:], each word once: a scalar
    head up to a 16-byte boundary, 16-byte stores (four words), a scalar
    tail; the row starts base_mod16 bytes past a 16-byte boundary."""
    wn = row.shape[0]
    head = min(wn, start + ((16 - (base_mod16 + 4 * start) % 16) % 16) // 4)
    n4 = (wn - head) // 4
    spans = [(start, head)] + [(head + 4 * i, head + 4 * i + 4)
                               for i in range(n4)] + [(head + 4 * n4, wn)]
    for lo, hi in spans:
        if hi - lo == 4:
            assert (base_mod16 + 4 * lo) % 16 == 0, "a misaligned store"
        assert (row[lo:hi] == -1).all(), "a word written twice"
        row[lo:hi] = 0
    assert hi == wn


def _fold(first, rest):
    out = first
    for run in rest:
        out = _combine(out, run)
    return out


def _emit(row, codes, q0, per, start, wn, final=False):
    """One thread's words from `start` (its first bit, the 32 bits before
    it); returns the next word index. A word it does not fill stays for a
    later thread, except at the stream's end (`final`)."""
    n = start[0] & 31
    w = start[0] >> 5
    acc = (start[1] >> (32 - n)) if n else 0
    for c, m in codes[q0:q0 + per]:
        for v, k in ((c & 0xFFFFFFFF, min(m, 32)), (c >> 32, max(m - 32, 0))):
            acc |= (v & ((1 << k) - 1)) << n
            n += k
            if n >= 32:
                assert w < wn and row[w] == -1, "a word written twice"
                row[w] = acc & 0xFFFFFFFF
                acc >>= 32
                n -= 32
                w += 1
    if final and n:
        assert row[w] == -1
        row[w] = acc
        w += 1
    return w


def _check_reads(tok, loads: _Loads):
    """K8 read `sym` exactly at the tokens and each match field exactly at
    the matches, so the 32-byte sectors it read are those that
    chip_smoke.sectors counts for pack_work's bound."""
    for key in FIELDS:
        want = tok["is_tok" if key == "sym" else "is_match"].reshape(-1)
        assert loads.read[key] == set(np.flatnonzero(want.numpy()).tolist())
        assert len({p // 4 for p in loads.read[key]}) == cs.sectors(
            tok["is_tok" if key == "sym" else "is_match"])


@pytest.mark.parametrize("threads,per", [(256, 16), (8, 4), (2, 3)])
@pytest.mark.parametrize("kind,level", [("text", 6), ("zeros", 6),
                                        ("random", 1), ("text", -2)])
def test_k8_model_equals_plain(kind, level, threads, per):
    """The model at K8's own shape (256 threads of 16 positions, every
    thread on the vector path), and at small chunks that make a row many
    chunks, some of whose bits begin and end inside one word (a run of
    zeros is a few long matches of 2-3 bits each), equals the plain version
    word for word, and reads each field only where K8 may."""
    tok, tables, _ = _cover(kind, level)
    seen: list = []
    loads = _Loads(tok)
    got_words, got_bits = k8_model(tok, tables, threads, per, seen, loads)
    words, bits = pk.pack_tokens_plain(tok, *tables)
    assert words.dtype == torch.int32
    assert np.array_equal(got_bits, bits.numpy())
    assert np.array_equal(got_words, words.numpy())
    _check_reads(tok, loads)
    if per == 16:
        assert loads.paths["scalar"] == 0
    if kind == "zeros" and threads * per < 64:
        assert any(n and (b >> 5) == ((b + n - 1) >> 5) for b, n in seen)
        assert any(n == 0 for _, n in seen)


def test_k8_model_with_fixed_and_fifteen_bit_tables():
    tok, tables, _ = _cover("text", 9)
    for tabs in (_fixed(tables[0].shape[0]), _fifteen(tables, 3)):
        got_words, got_bits = k8_model(tok, tabs, 8, 5)
        words, bits = pk.pack_tokens_plain(tok, *tabs)
        assert np.array_equal(got_bits, bits.numpy())
        assert np.array_equal(got_words, words.numpy())


def test_k8_model_takes_more_match_rounds():
    """A cover whose every position is a match of 3 at distance 1 (no real
    cover: a lane's 16 positions then hold 16 matches) takes a lane the
    most rounds of MATCH_BATCH matches there are, and still equals the
    plain version."""
    tok, tables, _ = _cover("text", 6)
    every = dict(tok)
    ones = torch.ones_like(tok["is_tok"])
    every.update(is_tok=ones, is_match=ones,
                 sym=torch.full_like(tok["sym"], 257),
                 len_idx=torch.zeros_like(tok["len_idx"]),
                 length=torch.full_like(tok["length"], 3),
                 dist_idx=torch.zeros_like(tok["dist_idx"]),
                 dist=torch.ones_like(tok["dist"]))
    loads = _Loads(every)
    got_words, got_bits = k8_model(every, tables, 256, 16, loads=loads)
    assert loads.rounds == -(-16 // MATCH_BATCH) > 1
    words, bits = pk.pack_tokens_plain(every, *tables)
    assert np.array_equal(got_words, words.numpy())
    assert np.array_equal(got_bits, bits.numpy())


def test_k8_model_reads_nothing_past_the_cover():
    """A field's value where K8 must not read it (no token, no match) may be
    anything: the model, whose loads read only under the masks, gives the
    plain version's words of the clean cover from a poisoned one."""
    tok, tables, _ = _cover("text", 6)
    rng = np.random.default_rng(5)
    poisoned = dict(tok)
    for key in FIELDS:
        keep = tok["is_tok" if key == "sym" else "is_match"]
        junk = torch.from_numpy(rng.integers(-2**62, 2**62, tuple(
            keep.shape), dtype=np.int64))
        poisoned[key] = torch.where(keep, tok[key], junk)
    got_words, got_bits = k8_model(poisoned, tables, 256, 16)
    words, bits = pk.pack_tokens_plain(tok, *tables)
    assert np.array_equal(got_words, words.numpy())
    assert np.array_equal(got_bits, bits.numpy())


@pytest.mark.parametrize("n", [4093, 1000])
def test_rows_of_n_not_a_multiple_of_16(n):
    """Rows of N = 4093 (odd: every other row's bools start off a 16-byte
    boundary, and its words too) and N = 1000 (a partial thread at each
    row's end): the wrapper against the reference, and the model, which
    takes K8's scalar path there, against the plain version."""
    tok, tables, _ = _cover("text", 6, n)
    assert tok["is_tok"].shape[1] == n
    words, bits = td.pack_tokens(tok, *tables)
    assert words.shape == (3, pk.words_per_row(n))
    want_words, want_bits = _reference(tok, tables)
    assert np.array_equal(words.numpy(), want_words)
    assert np.array_equal(bits.numpy(), want_bits)
    loads = _Loads(tok)
    got_words, got_bits = k8_model(tok, tables, 256, 16, loads=loads)
    assert np.array_equal(got_words, want_words)
    assert np.array_equal(got_bits, want_bits)
    assert loads.paths["scalar"] > 0 and loads.paths["vector"] > 0
    _check_reads(tok, loads)


def test_short_rows_and_an_empty_body():
    """n < N, n = 1 and no token at all (the end-of-block code alone)."""
    rows = torch.from_numpy(_rows("text"))
    nn = torch.tensor([BLOCK - 1000, 1, 0], dtype=torch.int64)
    tok = td.find_tokens(rows, nn, td.HIST, k=12, lazy=True, hist=td.HIST)
    tab = td.huffman_tables_plain(tok["ll_hist"], tok["dist_hist"], nn)
    tables = [tab[key] for key in ("use_ll", "ll_codes", "use_d", "d_codes")]
    words, bits = td.pack_tokens(tok, *tables)
    want_words, want_bits = _reference(tok, tables)
    assert np.array_equal(words.numpy(), want_words)
    assert np.array_equal(bits.numpy(), want_bits)
    assert int(bits[2]) == int(tables[0][2, 256])
    got_words, got_bits = k8_model(tok, tables, 4, 7)
    assert np.array_equal(got_words, want_words)


def test_the_bound_holds_at_its_worst():
    """A row of 15-bit codes and 3-byte matches as far apart as they can
    be costs at most 16 N + 15 bits, below the 32 Wn the words hold."""
    for n in (256, 4095, BLOCK, 98304):
        assert 16 * n + 15 < 32 * pk.words_per_row(n)
    tok, tables, _ = _cover("text", 6)
    _, bits = pk.pack_tokens_plain(tok, *_fifteen(tables, 5))
    assert int(bits.max()) <= 16 * BLOCK + 15


def test_pack_checks_its_arguments():
    tok, tables, _ = _cover("text", 1)
    with pytest.raises(ZippyError):
        pk.pack_tokens({**tok, "is_tok": tok["is_tok"].long()}, *tables)
    with pytest.raises(ZippyError):
        pk.pack_tokens({**tok, "sym": tok["sym"][:, :-1].contiguous()},
                       *tables)
    with pytest.raises(ZippyError):
        pk.pack_tokens({**tok, "dist": tok["dist"].t()}, *tables)
    with pytest.raises(ZippyError):
        pk.pack_tokens(tok, tables[0][:, :280], *tables[1:])
    with pytest.raises(ZippyError):
        pk.pack_tokens(tok, tables[0].int(), *tables[1:])
    with pytest.raises(ZippyError):
        pk.pack_tokens(tok, *tables[:3], tables[3].to("meta"))
    meta = {key: v.to("meta") for key, v in tok.items()}
    with pytest.raises(ZippyError, match="unsupported device"):
        pk.pack_tokens(meta, *(t.to("meta") for t in tables))
    big = {name: torch.zeros(1, pk.MAX_N + 1, dtype=dtype)
           for name, dtype in pk.TOKEN_INPUTS}
    with pytest.raises(ZippyError, match="positions"):
        pk.pack_tokens(big, *(t[:1] for t in tables))


def test_kernel_source_and_build():
    src = SOURCE.read_text()
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kThreads"] * consts["kPer"] == pk.CHUNK
    assert consts["kMaxChunks"] == pk.MAX_CHUNKS
    # The lanes' layout the model follows: 16 positions a thread, lanes
    # 32 positions apart, whole warps.
    assert consts["kPer"] == 16 and consts["kStride"] == 32
    assert consts["kThreads"] % 32 == 0
    assert consts["kMatchBatch"] == MATCH_BATCH
    fields = re.search(r"struct PackArgs \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"\* ?(\w+);", fields) == [
        name for name, _ in pk._Args._fields_]
    assert "pack.cu" in kb.CUDA_SOURCES
    assert "pack_tokens" in kb.LAUNCHES


def test_fetch_refuses_bits_past_the_words():
    """A row whose bit count overflows its packed words (tokens that are
    no cover) is refused where the encoder fetches it, not clipped."""
    tok, tables, _ = _cover("text", 6)
    words, bits = td.pack_tokens(tok, *tables)
    meta = torch.zeros(bits.shape[0], 2 + 286 + 30 + 19, dtype=torch.int64)
    meta[:, 1] = bits
    _, got_words = td._finish_fetch(td._start_fetch({
        "mode": meta[:, 0], "nbits": bits, "ll_lens": meta[:, 2:288],
        "d_lens": meta[:, 288:318], "cl_lens": meta[:, 318:], "words": words}))
    assert got_words.shape[1] == -(-int(bits.max()) // 32)
    meta[0, 1] = 32 * words.shape[1] + 1
    with pytest.raises(ZippyError, match="overflow"):
        td._finish_fetch(td._start_fetch({
            "mode": meta[:, 0], "nbits": meta[:, 1],
            "ll_lens": meta[:, 2:288], "d_lens": meta[:, 288:318],
            "cl_lens": meta[:, 318:], "words": words}))

"""K8's plain version (pack_kernels.pack_tokens_plain, reached through the
wrapper on CPU tensors) held against zippy_tpu's pack_tokens, jitted on
JAX's CPU backend, and a step-for-step numpy model of K8's chunks, scan,
look-back and word ownership held against the plain version.

The token covers come from the port's find_tokens on 4 KiB blocks; the
tables from its huffman_tables (K5's plain version), or the fixed ones,
or 15-bit lengths for every used symbol."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
FIXED = ("fixed_ll", "fixed_ll_codes", "fixed_d", "fixed_d_codes")


def _rows(kind: str, nrows: int = 3) -> np.ndarray:
    """(nrows, HIST + BLOCK + PAD) uint8 rows of one kind, history real."""
    width = td.HIST + BLOCK + td.PAD
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
    rows = torch.from_numpy(_rows(kind))
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
        words.append(np.asarray(w).astype(np.int64))
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
    assert words.dtype == torch.int64 and bits.dtype == torch.int64
    assert words.shape == (tok["is_tok"].shape[0], BLOCK // 2 + 8)
    want_words, want_bits = _reference(tok, tables)
    assert np.array_equal(bits.numpy(), want_bits)
    assert np.array_equal(words.numpy(), want_words)


# ---------------------------------------------------------------------------
# A numpy model of K8, step for step
# ---------------------------------------------------------------------------


def _codes(tok, tables, r: int):
    """Each position's whole code (value, length) in row r, the four
    components concatenated as K8 stages them."""
    g = {key: tok[key][r].numpy() for key in tok if key not in (
        "ll_hist", "dist_hist")}
    ll_l, ll_c, d_l, d_c = (t[r].numpy() for t in tables)
    cons = {name: const(name, torch.device("cpu")).numpy() for name in (
        "len_extra", "base_len", "dist_extra", "base_dist")}
    out = []
    for p in range(g["is_tok"].shape[0]):
        c, m = 0, 0
        if g["is_tok"][p]:
            s = int(g["sym"][p])
            m = int(ll_l[s])
            c = int(ll_c[s]) if m else 0
        if g["is_match"][p]:
            li, di = int(g["len_idx"][p]), int(g["dist_idx"][p])
            parts = ((int(g["length"][p] - cons["base_len"][li]),
                      int(cons["len_extra"][li])),
                     (int(d_c[di]), int(d_l[di])),
                     (int(g["dist"][p] - cons["base_dist"][di]),
                      int(cons["dist_extra"][di])))
            for v, n in parts:
                c |= (v & ((1 << n) - 1)) << m
                m += n
        out.append((c, m))
    return out


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


def k8_model(tok, tables, threads: int, per: int, seen=None):
    """K8's scheme on CPU arrays: chunks of threads * per positions, a
    (count, tail) run a thread, the CTA's exclusive scan, each chunk's
    prefix from the aggregates of the chunks before it in the order the
    look-back combines them (back to the nearest inclusive prefix), then
    each thread's accumulator writing the words whose last bit is its own.
    Asserts that no word is written twice; `seen` collects the chunks'
    (first bit, bit count)."""
    G, N = tok["is_tok"].shape
    wn = pk.words_per_row(N)
    chunk = threads * per
    nchunks = -(-N // chunk)
    words = np.full((G, wn), -1, np.int64)
    total = np.zeros(G, np.int64)
    rng = np.random.default_rng(11)
    for r in range(G):
        codes = _codes(tok, tables, r)
        codes += [(0, 0)] * (nchunks * chunk - N)
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
        # last partial word, zeros past it.
        end = prefixes[-1]
        eob = (int(tables[1][r, 256]) if int(tables[0][r, 256]) else 0,
               int(tables[0][r, 256]))
        w = _emit(words[r], [eob], 0, 1, end, wn, final=True)
        total[r] = end[0] + eob[1]
        assert (words[r, w:] == -1).all()
        words[r, w:] = 0
    assert (words >= 0).all()
    return words, total


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


@pytest.mark.parametrize("threads,per", [(256, 16), (8, 4), (2, 3)])
@pytest.mark.parametrize("kind,level", [("text", 6), ("zeros", 6),
                                        ("random", 1), ("text", -2)])
def test_k8_model_equals_plain(kind, level, threads, per):
    """The model at K8's own shape (256 threads of 16 positions), and at
    small chunks that make a row many chunks, some of whose bits begin and
    end inside one word (a run of zeros is a few long matches of 2-3 bits
    each), equals the plain version word for word."""
    tok, tables, _ = _cover(kind, level)
    seen: list = []
    got_words, got_bits = k8_model(tok, tables, threads, per, seen)
    words, bits = pk.pack_tokens_plain(tok, *tables)
    assert np.array_equal(got_bits, bits.numpy())
    assert np.array_equal(got_words, words.numpy())
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

"""K10's plain version (join_kernels.join_rows_plain, reached through the
wrapper on CPU tensors) held byte for byte to the host splice
(deflate_device._splice_group on a _ByteBitAppender) on the groups of
tests/_join_cases.py at every start phase, with its state row (next phase,
bits, the cut at a group's first stored row, no error); a step-for-step
model of K10 (the warp's scan of the rows' maps, the owner rule, the
payload's vector rounds with the fifth word from the next lane, the
gathered words) held to the plain version; what the join refuses; and the
encoder's streams through the join against zippy_tpu's at levels -2, 1, 6
and 9, on a payload of stored and text blocks in one-row groups that meet
at phases other than 0, with `join.rows` counting every block and no
launch on the CPU."""

import functools
import pathlib
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _join_cases as jc  # noqa: E402
from _torch_parity import mixed_payload, one_thread, shared_depth  # noqa: E402,F401
from zippy_tpu.ops import deflate_device as jd  # noqa: E402
from zippy_tpu_torch import profiling  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402
from zippy_tpu_torch.ops import join_kernels as jk  # noqa: E402
from zippy_tpu_torch.ops import kernel_build as kb  # noqa: E402

SOURCE = pathlib.Path(jk.__file__).resolve().parent.parent / "csrc" / "join.cu"
CASES = list(jc.cases(0))


def _const(name: str) -> int:
    return int(re.search(rf"\b{name} = (0x[0-9A-F]+|\d+)[;,]",
                         SOURCE.read_text()).group(1), 0)


def _splice(data: dict, last: int, phase: int):
    """The host splice of a case's group from `phase`: (its bytes, its
    bits, the bit past the block bits of its first stored row with a byte,
    -1 for none)."""
    meta, words = td._finish_fetch(td._start_fetch(data["res"]))
    out = td._ByteBitAppender()
    out.out, out.bitpos = bytearray(1 if phase else 0), phase
    cut, off = -1, data["offset"]
    for j, n in enumerate(data["lens"].tolist()):
        if cut < 0 and meta[j, 0] == 0 and n:
            cut = out.bitpos + 3
        td._splice_group(meta[j:j + 1], words[j:j + 1],
                         [(out, n, j == last)],
                         lambda _: data["raw"][j, off:off + n].numpy())
    return bytes(out.out), out.bitpos - phase, cut


@pytest.mark.parametrize("phase", range(8))
@pytest.mark.parametrize("case", CASES)
def test_plain_join_equals_host_splice(case, phase):
    rows, block, last = jc.cases(phase)[case]
    data = jc.group(rows, 7, block)
    piece, row = jc.join(data, last, phase)
    want, bits, cut = _splice(data, last, phase)
    assert row.tolist() == [(phase + bits) % 8, bits, cut, 0]
    assert piece.numpy().tobytes() == want


# ---------------------------------------------------------------------------
# A step-for-step model of K10
# ---------------------------------------------------------------------------

M32 = (1 << 32) - 1


def _ceil8(x):
    return (x + 7) & ~7


def _then(f, g):
    (fk, fa, fb), (gk, ga, gb) = f, g
    if gk == 0:
        return (0, fa + ga, 0) if fk == 0 else (1, fa, fb + ga)
    return (1, fa + ga, gb) if fk == 0 else (1, fa, _ceil8(fb + ga) + gb)


def _apply(f, x):
    return _ceil8(x + f[1]) + f[2] if f[0] else x + f[1]


def _window(bits: int, n: int, o: int) -> int:
    """Bits [o, o + 32) of an n-bit string held in the integer `bits`."""
    if o >= n or o <= -32 or n <= 0:
        return 0
    v = bits & ((1 << n) - 1)
    return (v >> o if o >= 0 else v << -o) & M32


def _k10_model(data: dict, last: int, phase: int):
    """K10 as csrc/join.cu runs it: warp 0 scans the rows' maps (two rows
    a lane, Hillis-Steele over 32 lanes); each of the rows x kSplit CTAs
    writes its row's share of the words it owns, the payload's interior by
    rounds of 4-word vectors (the fifth word from the next lane, lane 31
    loading its own) and the rest gathered by windows over each segment of
    the rows a word overlaps. Returns (the piece's words up to its last
    bit, the state row, how often each word was written)."""
    threads, split = _const("kThreads"), _const("kSplit")
    res, raw, off = data["res"], data["raw"].numpy(), data["offset"]
    rows, err = jk._rows(res, data["lens"], data["raw"], off,
                         data["block_size"])
    words = res["words"].numpy().view(np.uint32)
    hdr = res["hdr_words"].numpy().view(np.uint32)
    g, wn = len(rows), words.shape[1]
    as_int = [int.from_bytes(w.tobytes(), "little") for w in words]
    hdr_int = [int.from_bytes(w.tobytes(), "little") for w in hdr]

    def fn(m, nb, hb, n):
        if m:
            return (0, 3 + hb + nb, 0)
        if n == 0:
            return (0, 0, 0)
        return (1, 3, 32 + 8 * n + 40 * (-(-n // 0xFFFF) - 1))

    f = [[fn(*rows[2 * lane + h]) if 2 * lane + h < g else (0, 0, 0)
          for h in (0, 1)] for lane in range(32)]
    inc = [_then(*pair) for pair in f]
    d = 1
    while d < 32:
        inc = [_then(inc[lane - d], inc[lane]) if lane >= d else inc[lane]
               for lane in range(32)]
        d *= 2
    start = []
    for lane in range(32):
        s0 = _apply(inc[lane - 1] if lane else (0, 0, 0), phase)
        start += [s0, _apply(f[lane][0], s0)]
    start = start[:g] + [_apply(inc[31], phase)]
    end = start[g]
    stored = [j for j, (m, _, _, n) in enumerate(rows) if m == 0 and n]
    cut = start[stored[0]] + 3 if stored else -1
    cap = jk.piece_words(g, data["block_size"])
    if end > 32 * cap:
        err |= 16

    @functools.cache
    def body(k, done, chunk):
        return int.from_bytes(raw[k, off + done:off + done + chunk].tobytes(),
                              "little")

    def window(k, o):
        m, nb, hb, n = rows[k]
        final = k == last
        if m:
            v = _window(int(final) | (2 if m == 1 else 4), 3, o)
            if m == 2:
                v |= _window(hdr_int[k], hb, o - 3)
            return v | _window(as_int[k], nb, o - 3 - hb)
        v, t, done, c = 0, 0, 0, 0
        while done < n and t < o + 32:
            chunk = min(n - done, 0xFFFF)
            pad = -(start[k] + 3) % 8 if c == 0 else 5
            q = 35 + pad
            if t + q + 8 * chunk > o:
                pre = (int(final and done + chunk == n) | chunk << (3 + pad)
                       | (chunk ^ 0xFFFF) << (19 + pad))
                v |= _window(pre, q, o - t) | _window(
                    body(k, done, chunk), 8 * chunk, o - t - q)
            t += q + 8 * chunk
            done += chunk
            c += 1
        return v

    def gathered(w, j):
        v = 0
        for k in range(j, g):
            if start[k] >= 32 * w + 32:
                break
            if start[k + 1] > 32 * w:
                v |= window(k, 32 * w - start[k])
        return v

    piece, writes = {}, {}

    def store(w, v):
        if w < cap:
            piece[w] = v & M32
            writes[w] = writes.get(w, 0) + 1

    for j in range(g):
        s, e = start[j], start[j + 1]
        w_lo, w_hi = (0 if j == 0 else -(-s // 32)), -(-e // 32)
        fast_lo, fast_n = w_hi, 0
        m, nb, hb, _ = rows[j]
        if m:
            p = s + 3 + hb
            fast_lo = -(-p // 32)
            sh = 32 * fast_lo - p
            fast_n = (nb - sh) >> 5 if nb >= sh else 0
            nvec = (fast_n + 3) >> 2
            for y in range(split):
                for v0 in range(y * threads, nvec, split * threads):
                    for warp in range(threads // 32):
                        w4 = []
                        for lane in range(32):
                            v = v0 + 32 * warp + lane
                            q = 4 * v
                            w4.append([int(words[j, q + k])
                                       if v <= nvec and q + k < wn else 0
                                       for k in range(4)])
                        for lane in range(32):
                            v = v0 + 32 * warp + lane
                            q = 4 * v
                            if lane < 31:
                                nxt = w4[lane + 1][0]
                            else:
                                nxt = (int(words[j, q + 4])
                                       if v < nvec and q + 4 < wn else 0)
                            five = w4[lane] + [nxt]
                            for k in range(4):
                                if q + k < fast_n:
                                    store(fast_lo + q + k,
                                          (five[k] | five[k + 1] << 32)
                                          >> sh)
        n1, lo2 = fast_lo - w_lo, fast_lo + fast_n
        for i in range(n1 + w_hi - lo2):
            w = w_lo + i if i < n1 else lo2 + i - n1
            store(w, gathered(w, j))
    nwords = -(-end // 32)
    out = np.array([piece.get(w, 0) for w in range(min(nwords, cap))],
                   np.uint32)
    return out, [end & 7, end - phase, cut, err], writes


@pytest.mark.parametrize("case", CASES)
def test_k10_model_equals_plain(case):
    for phase in range(8):
        rows, block, last = jc.cases(phase)[case]
        data = jc.group(rows, 11, block)
        piece, row = jc.join(data, last, phase)
        words, state, writes = _k10_model(data, last, phase)
        assert state == row.tolist()
        assert set(writes) == set(range(len(words)))
        assert set(writes.values()) == {1}      # each word written once
        nbytes = len(piece)
        assert words.tobytes()[:nbytes] == piece.numpy().tobytes()
        assert not any(words.tobytes()[nbytes:])


@pytest.mark.parametrize("seed", range(4))
def test_k10_model_on_random_groups(seed):
    rng = np.random.default_rng(seed)
    g = int(rng.integers(1, jk.MAX_ROWS + 1))
    data = jc.group(jc.random_rows(g, seed), seed)
    phase, last = int(rng.integers(0, 8)), int(rng.integers(-1, g))
    piece, row = jc.join(data, last, phase)
    words, state, _ = _k10_model(data, last, phase)
    assert state == row.tolist()
    assert words.tobytes()[:len(piece)] == piece.numpy().tobytes()


# ---------------------------------------------------------------------------
# What the join refuses
# ---------------------------------------------------------------------------


def _refused(case: str):
    """A group the join must refuse, and the error bit it must set."""
    rows = [(2, 4000, 999, 1500), (0, 100, 0, 300), (1, 60, 0, 700)]
    wn = jc.BLOCK // 2 + 8
    if case == "words":
        rows[2] = (1, 32 * wn + 1, 0, 700)
        return rows, 1
    if case == "header":
        rows[0] = (2, 4000, 32 * jk.HDR_WORDS + 1, 1500)
        return rows, 2
    if case == "mode":
        rows[2] = (3, 60, 0, 700)
        return rows, 4
    if case == "length":
        rows[1] = (0, 100, 0, jc.BLOCK + 1)
        return rows, 8
    # Rows whose payloads overflow the piece, though each fits its words.
    return [(1, 32 * wn, 0, 700)] * 2, 16


@pytest.mark.parametrize("case", ["words", "header", "mode", "length",
                                  "capacity"])
def test_join_refuses_what_it_cannot_join(case):
    rows, bit = _refused(case)
    data = jc.group(rows, 3)
    piece, row = jc.join(data, -1, 5)
    assert row[jk.ERROR] == bit
    state = jk.new_state(1, "cpu")
    state[1] = row
    with pytest.raises(ZippyError, match=jk.ERRORS[bit]):
        td._fetch_piece(piece, state)


def test_wrapper_matches_the_kernel_source():
    src = SOURCE.read_text()
    fields = re.search(r"struct JoinArgs \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"\* ?(\w+);", fields) == [
        name for name, _ in jk._Args._fields_]
    assert _const("kMaxRows") == jk.MAX_ROWS == td.MAX_GROUP
    assert _const("kHdrWords") == jk.HDR_WORDS
    assert _const("kChunk") == jk.STORED_CHUNK
    assert {_const(name) for name in ("kWordsOverflow", "kHeaderOverflow",
                                      "kBadMode", "kBlockLength",
                                      "kCapacity")} == set(jk.ERRORS)
    assert "join.cu" in kb.CUDA_SOURCES and "join_rows" in kb.LAUNCHES
    # No fallback: a tensor that is neither on the CPU nor on a card.
    data = jc.group([(1, 60, 0, 700)], 1)
    meta = {k: v.to("meta") for k, v in data["res"].items()}
    with pytest.raises(ZippyError, match="unsupported device"):
        jk.join_rows(meta, data["lens"].to("meta"), data["raw"].to("meta"),
                     data["offset"], data["block_size"], -1,
                     jk.new_state(1, "meta"), 0)


# ---------------------------------------------------------------------------
# The encoder's streams through the join
# ---------------------------------------------------------------------------

BS = 2048
# Text and random (stored) blocks, in groups of one row: pieces meet at
# phases that are not 0, and (but at level -2) a stored row's piece
# starts at one of them.
MIXED = b"".join([mixed_payload(BS, 5), np.random.default_rng(8).integers(
    0, 256, BS + 700, dtype=np.uint8).tobytes(), mixed_payload(2 * BS, 6),
    np.random.default_rng(9).integers(0, 256, BS // 2,
                                       dtype=np.uint8).tobytes()])


@pytest.mark.parametrize("level", [-2, 1, 6, 9])
def test_deflate_through_the_join_equals_reference(shared_depth, one_thread,
                                                   monkeypatch, level):
    if level == -2:     # zippy_tpu's deflate runs its host codec there
        want = jd.deflate_array(jnp.asarray(np.frombuffer(MIXED, np.uint8)),
                                -2, block_size=BS)
    else:
        want = jd.deflate(MIXED, level, block_size=BS)
    monkeypatch.setattr(td, "_group_size", lambda k, block_size: 1)
    fetched, fetch = [], td._fetch_piece

    def fetch_piece(piece, state):
        fetched.append(fetch(piece, state))
        return fetched[-1]

    monkeypatch.setattr(td, "_fetch_piece", fetch_piece)
    launches = dict(kb.LAUNCHES)
    profiling.enable()
    try:
        with profiling.call("compress"):
            got = td.deflate(MIXED, level, BS, device="cpu")
        (rec,) = profiling.recent(1)
    finally:
        profiling.disable()
    assert got == want
    assert zlib.decompress(got, wbits=-15) == MIXED
    nblocks = -(-len(MIXED) // BS)
    assert rec.counters["join.rows"] == nblocks
    assert len(fetched) == nblocks
    assert any(phase for phase, *_ in fetched)
    assert level == -2 or any(phase and cut >= 0
                              for phase, _, cut, _ in fetched)
    assert rec.counters["fetch.used_bytes"] == len(got)
    assert kb.LAUNCHES == launches

"""zippy_tpu_torch's DEFLATE encoder against zippy_tpu's, on the CPU.

The port runs its plain PyTorch path (device="cpu"); zippy_tpu runs as its
own tests run it. Every integer stage is compared element for element.

The Kraft builder's float step depends on the last ulp of the ideal depths
log2(total / freq), and XLA-CPU contracts the reference's `log2(x) * (1/ln 2)`
into an FMA with the following `+ t` when `_encode_group` is jitted, so the
jitted reference does not even agree with itself run op by op. The tests
therefore give both sides the same ideal depths: the port's `_ideal_depth`
swapped for `jnp.log2` against the reference's eager `_kraft_lengths`, and,
for whole (jitted) streams, the reference's `log2` routed through a host
callback to the port's `_ideal_depth`, which XLA cannot fuse.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import mixed_payload, shared_depth  # noqa: E402,F401
from zippy_tpu.ops import deflate_device as jd  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402


def _jax_log2(ratio: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.log2(jnp.asarray(ratio.numpy()))))


def _to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _padded_block(data: bytes, hist: int, n_block: int) -> np.ndarray:
    pad = np.zeros(hist + n_block + td.PAD, np.uint8)
    arr = np.frombuffer(data, np.uint8)[: hist + n_block]
    pad[: arr.size] = arr
    return pad


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4, 12, 32])
def test_find_tokens_matches_reference(k):
    data = mixed_payload(3 * 2048, seed=5)
    n_block, hist = 2048, 1024
    for h, hist_len, min3, lazy in ((0, 0, False, k > 2), (hist, 700, True,
                                                           True)):
        pad = _padded_block(data if h else data[hist:], h, n_block)
        ref = jd.find_tokens(jnp.asarray(pad), np.int32(n_block - 5),
                             np.int32(hist_len), k=k, lazy=lazy, hist=h,
                             min3=min3)
        got = td.find_tokens(torch.from_numpy(pad)[None], n_block - 5,
                             hist_len, k=k, lazy=lazy, hist=h, min3=min3)
        for key in ref:
            assert np.array_equal(np.asarray(ref[key]), _to_np(got[key][0])), (
                k, h, min3, key)


def test_find_tokens_lits_only_matches_reference():
    pad = _padded_block(mixed_payload(2048, seed=7), 0, 2048)
    ref = jd.find_tokens(jnp.asarray(pad), np.int32(2000), lits_only=True)
    got = td.find_tokens(torch.from_numpy(pad)[None], 2000, lits_only=True)
    for key in ref:
        assert np.array_equal(np.asarray(ref[key]), _to_np(got[key][0])), key


def _histograms():
    rng = np.random.default_rng(42)
    cases = []
    for _ in range(40):
        s = int(rng.integers(2, 287))
        freq = np.zeros(286, np.int64)
        kind = rng.integers(0, 4)
        if kind == 0:
            freq[:s] = rng.integers(1, 1000, s)
        elif kind == 1:  # Zipf-like
            freq[:s] = (10000 / (1 + np.arange(s))).astype(np.int64) + 1
        elif kind == 2:  # one dominant symbol
            freq[:s] = 1
            freq[0] = 100000
        else:  # powers of two (exact-depth edge cases)
            freq[:s] = 2 ** rng.integers(0, 16, s)
        rng.shuffle(freq)
        cases.append(freq)
    cases.append(np.eye(286, dtype=np.int64)[3] * 7)       # one symbol
    cases.append(np.eye(286, dtype=np.int64)[[5, 200]].sum(0) * [3])  # two
    cases.append(np.ones(286, np.int64))                   # all symbols
    cases.append(np.zeros(286, np.int64))                  # none
    return cases


@pytest.mark.parametrize("limit", [15, 7])
def test_kraft_lengths_match_reference_given_jnp_log2(monkeypatch, limit):
    """The reference run op by op (each call retraces its loops, so a few
    histograms of every kind) against the port on jnp.log2's depths."""
    monkeypatch.setattr(td, "_ideal_depth", _jax_log2)
    cases = [f[:19] if limit == 7 else f for f in _histograms()[::6]]
    got = td._kraft_lengths(torch.from_numpy(np.stack(cases)), limit).numpy()
    for freq, lens in zip(cases, got):
        ref = np.asarray(jd._kraft_lengths(jnp.asarray(freq.astype(np.int32)),
                                           limit))
        assert np.array_equal(ref, lens), (limit, freq)


@pytest.mark.parametrize("limit", [15, 7])
def test_kraft_lengths_match_jitted_reference_given_same_depths(shared_depth,
                                                                limit):
    cases = np.stack([f[:19] if limit == 7 else f for f in _histograms()])
    ref = jax.jit(jax.vmap(lambda f: jd._kraft_lengths(f, limit)))(
        jnp.asarray(cases.astype(np.int32)))
    got = td._kraft_lengths(torch.from_numpy(cases), limit)
    assert np.array_equal(np.asarray(ref), got.numpy())


def test_kraft_lengths_own_depth_valid():
    """With the port's own depths the code is still Kraft-complete and
    within 1% of optimal package-merge."""
    for limit in (15, 7):
        cases = [f[:19] if limit == 7 else f for f in _histograms()]
        got = td._kraft_lengths(torch.from_numpy(np.stack(cases)),
                                limit).numpy()
        for freq, lens in zip(cases, got):
            active = freq > 0
            assert (lens[~active] == 0).all()
            assert ((lens[active] >= 1) & (lens[active] <= limit)).all()
            if active.sum() >= 2:
                assert (2.0 ** -lens[active].astype(np.float64)).sum() == 1.0
                opt = jd.build_code_lengths(freq, limit)
                assert (freq * lens).sum() <= (freq * opt).sum() * 1.01 + 16


def test_header_codes_and_pack_match_reference(shared_depth):
    data = mixed_payload(2 * 2048, seed=9)
    for k in (12,):
        pad = _padded_block(data, 0, 2048)
        tok = jd.find_tokens(jnp.asarray(pad), np.int32(2048), k=k)
        kraft = jax.jit(jd._kraft_lengths, static_argnums=1)
        ll = kraft(tok["ll_hist"], 15)
        dl = kraft(tok["dist_hist"], 15)
        t_ll = torch.from_numpy(np.asarray(ll, np.int64))[None]
        t_dl = torch.from_numpy(np.asarray(dl, np.int64))[None]

        ref_h = jax.jit(jd._header_stats_device)(ll, dl)
        got_h = td._header_stats_device(t_ll, t_dl)
        for r, g in zip(ref_h, got_h):
            assert np.array_equal(np.asarray(r), g[0].numpy())

        ref_c = [jd._rev_codes_device(x) for x in (ll, dl)]
        got_c = [td._rev_codes_device(x) for x in (t_ll, t_dl)]
        for r, g in zip(ref_c, got_c):
            assert np.array_equal(np.asarray(r), g[0].numpy())

        words, nbits = jd.pack_tokens(tok, ll, ref_c[0], dl, ref_c[1])
        t_tok = {key: torch.from_numpy(np.asarray(v).astype(
            bool if v.dtype == jnp.bool_ else np.int64))[None]
            for key, v in tok.items()}
        g_words, g_nbits = td.pack_tokens(t_tok, t_ll, got_c[0], t_dl,
                                          got_c[1])
        assert int(nbits) == int(g_nbits[0])
        assert g_words.dtype == torch.int32     # uint32 bit patterns
        assert np.array_equal(np.asarray(words).astype(np.uint32).view(
            np.int32), g_words[0].numpy())

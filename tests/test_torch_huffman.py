"""K5's plain version (deflate_device.huffman_tables_plain) against
zippy_tpu's encode_block between find_tokens and pack_tokens, on the CPU;
and the K5 wrapper, build entry and wiring as far as a host without CUDA
reaches them (chip_smoke.py holds the kernel against the plain version on
the card).

The reference is zippy_tpu's own code, jitted and vmapped as its
_encode_group runs it: encode_block with find_tokens replaced by the row's
histograms and pack_tokens by the tables it is given, so that its
`_kraft_lengths`, `_header_stats_device`, `_rev_codes_device` and its mode
choice run unchanged. Both sides take the port's ideal depths (see
tests/test_torch_deflate.py for why), and every output must be equal
element for element.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import SharedDepth, one_thread  # noqa: E402,F401
from zippy_tpu.ops import deflate_device as jd  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402
from zippy_tpu_torch.ops import huffman_kernels as hk  # noqa: E402
from zippy_tpu_torch.ops import kernel_build as kb  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
LL, D = 286, 30


def _row(ll: dict | np.ndarray = (), d: dict | np.ndarray = (),
         n: int | None = None):
    """(ll_hist, dist_hist, n): a dict gives symbol -> count; n defaults to
    the literal count plus 3 bytes a match."""
    out = []
    for spec, size in ((ll, LL), (d, D)):
        h = np.zeros(size, np.int64)
        if isinstance(spec, dict):
            for sym, count in spec.items():
                h[sym] = count
        else:
            h[:len(spec)] = spec
        out.append(h)
    if n is None:
        n = int(out[0][:256].sum() + 3 * out[0][257:].sum())
    return out[0], out[1], n


def _cases() -> dict:
    rng = np.random.default_rng(1010)
    zipf = []
    for s in (40, 120, 286):
        ll = np.zeros(LL, np.int64)
        ll[:s] = rng.zipf(1.3, s) % 4096
        ll[256] = 1
        zipf.append(_row(rng.permutation(ll), rng.zipf(1.5, D) % 700))
    dyadic = [_row(2 ** rng.integers(0, 16, s), 2 ** rng.integers(0, 12, D))
              for s in (3, 64, 286)]
    uniform = [_row(np.full(LL, 50), np.full(D, 9)),
               _row(rng.integers(1, 1000, LL), rng.integers(1, 1000, D))]
    none = [_row(n=0), _row(n=1000), _row(d={4: 7}, n=5)]
    one = [_row({3: 7}), _row({256: 1}, n=0), _row({285: 40000}, {29: 1}),
           _row({0: 1 << 16}, {0: 3})]
    two = [_row({5: 3, 200: 3}), _row({0: 1, 1: 1 << 16}, {7: 2, 8: 900}),
           _row({256: 1, 257: 5}, {0: 1})]
    # Frequencies about the 2^20 clamp of the sort keys, and at 2^22.
    near = [_row(rng.integers((1 << 20) - 4, (1 << 20) + 4, 10)),
            _row({1: (1 << 20) - 1, 2: 1 << 20, 3: (1 << 20) + 1, 4: 1,
                  256: 1}, {0: (1 << 20) - 1, 1: 1 << 20})]
    big = [_row({0: 1 << 22, 9: 1 << 22, 256: 1, 260: 5}, {2: 1 << 22, 3: 1}),
           _row(np.concatenate([[1 << 22] * 3, rng.integers(1, 100, 100)]),
                n=(1 << 22) * 3 + 5000)]
    # Stored: flat literals, as many bytes as literals, and far matches
    # whose extra bits make them dearer than their bytes; fixed: a few
    # literals; dynamic: skewed text.
    modes = [_row(np.full(256, 256)), _row(rng.integers(200, 300, 256)),
             _row({257: 1000, 256: 1}, {29: 1000}, n=1000),
             _row({97: 3, 98: 2, 99: 1, 256: 1}), _row({97: 3, 256: 1}),
             _row({65: 10, 66: 10, 256: 1, 258: 2}, {0: 2}), zipf[0]]
    return {"zipf": zipf, "dyadic": dyadic, "uniform": uniform, "none": none,
            "one_active": one, "two_active": two, "near_2_20": near,
            "at_2_22": big, "modes": modes}


CASES = _cases()


def _stub_find_tokens(data_pad, n, hist_len=0, **kwargs):
    return {"ll_hist": data_pad[:LL], "dist_hist": data_pad[LL:]}


def _stub_pack_tokens(tok, use_ll, ll_codes, use_d, d_codes):
    return (use_ll, ll_codes, use_d, d_codes), jnp.int32(0)


@pytest.fixture(scope="module")
def reference():
    """zippy_tpu's tables of every case's rows, from one jitted, vmapped
    encode_block on the port's ideal depths: {case: {output: array}}."""
    rows = [r for case in CASES.values() for r in case]
    hists = np.stack([np.concatenate([ll, d]) for ll, d, _ in rows])
    ns = np.array([n for _, _, n in rows])
    assert hists.max() < 2**31 and ns.max() < 2**27   # the reference's int32
    with pytest.MonkeyPatch.context() as mp:
        jax.clear_caches()
        mp.setattr(jd, "jnp", SharedDepth())
        mp.setattr(jd, "find_tokens", _stub_find_tokens)
        mp.setattr(jd, "pack_tokens", _stub_pack_tokens)
        res = jax.jit(jax.vmap(lambda h, n: jd.encode_block(h, n)))(
            jnp.asarray(hists.astype(np.int32)), jnp.asarray(ns, jnp.int32))
        res = jax.tree.map(np.asarray, res)
    jax.clear_caches()
    use_ll, ll_codes, use_d, d_codes = res["words"]
    flat = {"ll_lens": res["ll_lens"], "d_lens": res["d_lens"],
            "cl_lens": res["cl_lens"], "mode": res["mode"], "use_ll": use_ll,
            "ll_codes": ll_codes, "use_d": use_d, "d_codes": d_codes}
    out, at = {}, 0
    for name, case in CASES.items():
        out[name] = {key: v[at:at + len(case)] for key, v in flat.items()}
        at += len(case)
    return out


def _tensors(rows):
    return (torch.from_numpy(np.stack([r[0] for r in rows])),
            torch.from_numpy(np.stack([r[1] for r in rows])),
            torch.tensor([r[2] for r in rows], dtype=torch.int64))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_reference(one_thread, reference, case):
    got = td.huffman_tables_plain(*_tensors(CASES[case]))
    assert set(got) == {name for name, _ in hk.OUTPUTS}
    for key, want in reference[case].items():
        g = got[key]
        assert g.dtype == torch.int64, key
        assert np.array_equal(want.astype(np.int64), g.numpy()), (case, key)


def test_cases_pick_every_mode(reference):
    """The `modes` rows take the stored, fixed and dynamic blocks, and the
    edge rows' lengths are what the code promises: zeros for no symbol, one
    length-1 code for a lone symbol."""
    assert reference["modes"]["mode"].tolist() == [0, 0, 0, 1, 1, 2, 2]
    assert not reference["none"]["ll_lens"].any()
    lens = reference["one_active"]["ll_lens"]
    assert (lens.sum(axis=1) == 1).all() and lens.max() == 1


def test_huffman_tables_on_cpu_is_the_plain_version(one_thread):
    rows = CASES["zipf"] + CASES["modes"]
    before = dict(kb.LAUNCHES)
    got = hk.huffman_tables(*_tensors(rows))
    want = td.huffman_tables_plain(*_tensors(rows))
    assert kb.LAUNCHES == before
    assert all(torch.equal(got[key], want[key]) for key in want)
    assert [tuple(got[name].shape) for name, _ in hk.OUTPUTS] == [
        (len(rows), cols) if cols else (len(rows),)
        for _, cols in hk.OUTPUTS]


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "strided",
                                 "device"])
def test_huffman_tables_rejects_what_k5_does_not_take(bad):
    ll, d, n = _tensors(CASES["zipf"])
    if bad == "dtype":
        ll = ll.to(torch.int32)
    elif bad == "width":
        d = torch.zeros(len(n), 31, dtype=torch.int64)
    elif bad == "rows":
        n = n[:-1]
    elif bad == "strided":
        ll = torch.zeros(len(n), 2 * LL, dtype=torch.int64)[:, ::2]
    else:
        n = n.to("meta")
    with pytest.raises(ZippyError):
        hk.huffman_tables(ll, d, n)


def test_encode_group_takes_the_tables_from_huffman_tables(one_thread,
                                                           monkeypatch):
    """Every encode group calls the wrapper once, with the group's
    histograms, and the stream still decodes."""
    import zlib

    calls = []
    wrapped = hk.huffman_tables

    def counted(ll, d, n):
        calls.append(ll.shape[0])
        return wrapped(ll, d, n)

    monkeypatch.setattr(hk, "huffman_tables", counted)
    monkeypatch.setattr(td, "MAX_GROUP", 2)
    data = (b"tables from one launch a group " * 500)[:5 * 1024]
    blob = td.deflate(data, 6, block_size=1024, device="cpu")
    assert calls == [2, 2, 1]
    assert zlib.decompress(blob, -15) == data


def test_kernel_build_builds_huffman_without_fast_math(tmp_path,
                                                       monkeypatch):
    assert "huffman.cu" in kb.CUDA_SOURCES
    assert "huffman_tables" in kb.LAUNCHES
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kb.shutil, "which", lambda name: None)
    cmd = kb._command(kb.CSRC / "huffman.cu", tmp_path / "lib.so")
    assert cmd[0] == str(tmp_path / "bin" / "nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in arg or "fast-math" in arg for arg in cmd)


def test_huffman_kernels_imports_without_cuda_nvcc_or_jax(tmp_path):
    """A fresh interpreter with no nvcc on its PATH imports the module,
    which builds and loads nothing and leaves jax out."""
    code = (
        "import sys\n"
        "from zippy_tpu_torch.ops import huffman_kernels as hk\n"
        "from zippy_tpu_torch.ops import kernel_build as kb\n"
        "assert hk._lib.cache_info().currsize == 0\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'zippy_tpu')]\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_HOME")}
    env["PATH"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def _cu_int(text: str, name: str) -> int:
    import re

    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, name
    return int(m.group(1))


def test_layout_constants_match_the_kernel_source():
    """The wrapper's LL_WARPS, ROWS_PER_CTA and THREADS are K5's kLLWarps,
    kRowsPerCta and kThreads (two litlen groups and the distance warp), a
    CTA's threads fit the card's 1,024, and the kernel's named barriers are
    ids 1 to 15 (0 is __syncthreads, which it never uses)."""
    text = (kb.CSRC / "huffman.cu").read_text()
    assert _cu_int(text, "kLLWarps") == hk.LL_WARPS
    assert _cu_int(text, "kRowsPerCta") == hk.ROWS_PER_CTA
    assert "kThreads = (2 * kLLWarps + 1) * 32;" in text
    assert hk.THREADS == (2 * hk.LL_WARPS + 1) * 32 <= 1024
    assert "__syncthreads(" not in text
    import re

    bars = re.search(r"constexpr int (kBarA = 1,[^;]*);", text).group(1)
    ids = [int(v) for v in re.findall(r"= (\d+)", bars)]
    assert sorted(ids) == list(range(1, len(ids) + 1)) and max(ids) <= 15

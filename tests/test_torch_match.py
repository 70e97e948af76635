"""zippy_tpu_torch's match finding (find_tokens, kernel K7's plain version)
against zippy_tpu's find_tokens, on the CPU.

The port runs its plain PyTorch path: `deflate_device.find_tokens` on CPU
tensors dispatches to `match_kernels.find_tokens_plain`. zippy_tpu's
find_tokens runs on JAX's CPU backend, once a row, as tests/
test_torch_deflate.py runs it. Every output is compared element for
element, on seeded rows of the kinds where a fresh design drifts from the
reference: an all-zero block (one hash bucket holds every position), a
short period (ties of the rank and its 32-byte cap), a block that is not
the last (its bytes past n are real), candidates inside the unreal part of
the history, matches that reach 64 bytes and extend to 258, many 3-byte
matches (min3, and its demotion where a longer match starts two ahead) and
random bytes, at the k, lazy and min3 of levels 1, 4, 6, 7 and 9. K7
itself runs only on the card: chip_smoke.py holds it to this plain
version there.
"""

import inspect
import os
import re
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import mixed_payload, one_thread  # noqa: E402,F401
from zippy_tpu.ops import deflate_device as jd  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402
from zippy_tpu_torch.ops import kernel_build as kb  # noqa: E402
from zippy_tpu_torch.ops import match_kernels as mk  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BLOCK = 2048
LEVELS = (1, 4, 6, 7, 9)        # k 2, 4, 12, 16, 32


def _rows(hist: int, seed: int) -> list:
    """(kind, row (hist + N_BLOCK + PAD,) uint8, n, hist_len) of every
    kind, seeded."""
    rng = np.random.default_rng(seed)
    width = hist + N_BLOCK + td.PAD
    text = np.frombuffer(mixed_payload(width, seed), np.uint8)
    rows = [("text", text, N_BLOCK, hist),
            ("zeros", np.zeros(width, np.uint8), N_BLOCK, hist)]
    period = rng.integers(0, 256, int(rng.integers(2, 4)), dtype=np.uint8)
    rows.append(("short_period", np.resize(period, width), N_BLOCK - 7,
                 hist))
    # Not the last block: the bytes past n continue the text.
    rows.append(("not_last", np.frombuffer(mixed_payload(width, seed + 1),
                                           np.uint8), N_BLOCK - 300, hist))
    # The history repeats what follows, but only its last third is real.
    tail = np.frombuffer(mixed_payload(N_BLOCK + td.PAD, seed + 2), np.uint8)
    rows.append(("unreal_history", np.concatenate(
        [np.resize(tail, hist), tail]), N_BLOCK, hist // 3))
    seg = rng.integers(0, 256, 300, dtype=np.uint8)
    rows.append(("long_matches", np.resize(np.concatenate(
        [seg, rng.integers(0, 256, 37, dtype=np.uint8)]), width), N_BLOCK,
        hist))
    # A 16-letter alphabet: most 3-grams recur within 4096 bytes, 4-grams
    # rarely, so 3-matches meet longer matches two positions ahead.
    rows.append(("three_grams", rng.integers(0, 16, width, dtype=np.uint8),
                 N_BLOCK - 1, hist))
    rows.append(("random", rng.integers(0, 256, width, dtype=np.uint8),
                 N_BLOCK, hist))
    rows.append(("short_last", text[::-1].copy(), 100, hist // 2))
    return rows


def _reference(row: np.ndarray, n: int, hist_len: int, **params) -> dict:
    out = jd.find_tokens(jnp.asarray(row), np.int32(n), np.int32(hist_len),
                         **params)
    return {key: np.asarray(v) for key, v in out.items()}


def _assert_rows_match(rows: list, got: dict, params: dict) -> None:
    for g, (kind, row, n, hist_len) in enumerate(rows):
        ref = _reference(row, n, hist_len, **params)
        assert set(ref) == set(got)
        for key, want in ref.items():
            have = got[key][g].numpy()
            assert have.dtype == (np.bool_ if key in ("is_tok", "is_match")
                                  else np.int64), key
            assert np.array_equal(want, have), (kind, key, params)


def _group(rows: list):
    return (torch.from_numpy(np.stack([r for _, r, _, _ in rows])),
            torch.tensor([n for _, _, n, _ in rows]),
            torch.tensor([h for _, _, _, h in rows]))


@pytest.mark.parametrize("hist", [0, 1024])
@pytest.mark.parametrize("level", LEVELS)
def test_find_tokens_rows_match_reference(one_thread, level, hist):
    k, lazy, min3 = td._level_params(level)
    params = {"k": k, "lazy": lazy, "hist": hist, "min3": min3}
    rows = _rows(hist, 100 + level)
    data, n, hist_len = _group(rows)
    got = td.find_tokens(data, n, hist_len, **params)
    _assert_rows_match(rows, got, params)
    # The kinds did what they are for.
    kinds = [kind for kind, _, _, _ in rows]
    length = got["length"]
    assert length[kinds.index("zeros")].max() == 258
    assert length[kinds.index("long_matches")].max() == 258
    assert not got["is_match"][kinds.index("random")].any()
    assert (length[kinds.index("three_grams")] == 3).any() == min3


def test_find_tokens_three_rows_in_one_call(one_thread):
    """G = 3 rows, each with its own n and hist_len, in one call."""
    hist = 1024
    rows = [r for r in _rows(hist, 7) if r[0] in ("text", "not_last",
                                                  "unreal_history")]
    rows = [(kind, row, n - 61 * i, max(h - 400 * i, 0))
            for i, (kind, row, n, h) in enumerate(rows)]
    params = {"k": 12, "lazy": True, "hist": hist, "min3": False}
    _assert_rows_match(rows, td.find_tokens(*_group(rows), **params), params)


def test_find_tokens_lits_only_rows_match_reference(one_thread):
    hist = 1024
    rows = _rows(hist, 9)[:3]
    params = {"k": 2, "lazy": False, "hist": hist, "min3": False,
              "lits_only": True}
    _assert_rows_match(rows, td.find_tokens(*_group(rows), **params), params)


def test_find_tokens_on_cpu_is_the_plain_version(one_thread):
    """The dispatcher on CPU tensors runs find_tokens_plain (no launch), and
    takes one n and hist_len for every row as the plain version does."""
    rows = _rows(512, 11)
    data = _group(rows)[0]
    params = {"k": 16, "lazy": True, "hist": 512, "min3": True}
    before = dict(kb.LAUNCHES)
    got = td.find_tokens(data, N_BLOCK - 3, 200, **params)
    want = mk.find_tokens_plain(data, N_BLOCK - 3, 200, **params)
    assert kb.LAUNCHES == before
    assert set(got) == set(want)
    assert all(torch.equal(got[key], want[key]) for key in want)
    assert got["ll_hist"].shape == (len(rows), 286)
    assert got["dist_hist"].shape == (len(rows), 30)


@pytest.mark.parametrize("bad", ["dtype", "dim", "strided", "n_dtype",
                                 "n_rows", "device", "too_wide", "k_zero",
                                 "k_large", "no_block"])
def test_match_tokens_rejects_what_k7_does_not_take(bad):
    data, n, hist_len = _group(_rows(0, 13)[:2])
    params = {"k": 4, "lazy": True, "hist": 0, "min3": False,
              "lits_only": False}
    if bad == "dtype":
        data = data.to(torch.int16)
    elif bad == "dim":
        data = data[0]
    elif bad == "strided":
        data = torch.zeros(2, 2 * data.shape[1], dtype=torch.uint8)[:, ::2]
    elif bad == "n_dtype":
        n = n.to(torch.int32)
    elif bad == "n_rows":
        hist_len = hist_len[:1]
    elif bad == "device":
        n = n.to("meta")
    elif bad == "too_wide":
        data = torch.zeros(1, (1 << 17) + 1 + td.PAD, dtype=torch.uint8)
        n, hist_len = n[:1], hist_len[:1]
    elif bad == "k_zero":
        params["k"] = 0
    elif bad == "k_large":
        params["k"] = mk.MAX_K + 1
    else:
        params["hist"] = data.shape[1] - td.PAD
    with pytest.raises(ZippyError):
        mk.match_tokens(data, n, hist_len, **params)


def test_encode_group_finds_tokens_through_match_tokens(one_thread,
                                                        monkeypatch):
    """Every encode group calls the wrapper once, with the group's rows,
    and the stream still decodes."""
    calls = []
    wrapped = mk.match_tokens

    def counted(data_pad, n, hist_len, **params):
        calls.append((data_pad.shape[0], params["k"]))
        return wrapped(data_pad, n, hist_len, **params)

    monkeypatch.setattr(mk, "match_tokens", counted)
    monkeypatch.setattr(td, "MAX_GROUP", 2)
    data = mixed_payload(5 * 1024, seed=4)
    blob = td.deflate(data, 6, block_size=1024, device="cpu")
    assert calls == [(2, 12), (2, 12), (1, 12)]
    assert zlib.decompress(blob, -15) == data


def test_launches_per_group():
    assert mk.launches_per_group(False) == mk.LAUNCHES_PER_GROUP == 10
    assert mk.launches_per_group(True) == mk.LAUNCHES_LITS_ONLY == 1


def test_kernel_build_builds_match(tmp_path, monkeypatch):
    assert "match.cu" in kb.CUDA_SOURCES
    assert "match_tokens" in kb.LAUNCHES
    assert '#include "device_scope.cuh"' in (kb.CSRC / "match.cu").read_text()
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kb.shutil, "which", lambda name: None)
    cmd = kb._command(kb.CSRC / "match.cu", tmp_path / "lib.so")
    assert cmd[0] == str(tmp_path / "bin" / "nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd


def test_match_kernels_imports_without_cuda_nvcc_or_jax(tmp_path):
    """A fresh interpreter with no nvcc on its PATH imports the module,
    which builds and loads nothing and leaves jax out."""
    code = (
        "import sys\n"
        "from zippy_tpu_torch.ops import match_kernels as mk\n"
        "assert mk._lib.cache_info().currsize == 0\n"
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


def _reference_order(row: np.ndarray, three: bool):
    """The reference's sort of one row's keys, as zippy_tpu's find_tokens
    computes it (zippy_tpu/ops/deflate_device.py:141-143, and the 3-byte
    keys at :278-284): (keys in order, order, h)."""
    NA = row.shape[0] - td.PAD
    U = jd._U
    b = jnp.asarray(row).astype(U)
    v = b[:NA] | (b[1:NA + 1] << U(8)) | (b[2:NA + 2] << U(16)) | (
        b[3:NA + 3] << U(24))
    if three:
        v = v & U(0xFFFFFF)
    h = ((v * U(0x9E3779B1)) >> U(32 - jd.HASH_BITS)).astype(jnp.int32)
    pos = jnp.arange(NA, dtype=jnp.int32)
    key = (h.astype(U) << U(17)) | pos.astype(U)
    order = jnp.argsort(key).astype(jnp.int32)
    return np.asarray(key[order]), np.asarray(order), np.asarray(h)


@pytest.mark.parametrize("min3", [False, True])
@pytest.mark.parametrize("hist", [0, 32768])
def test_sort_keys_plain_is_the_reference_order(one_thread, hist, min3):
    """K7's sort stage, plainly: the keys in the reference's argsort order,
    each position's index in it and, under min3, the same of the 3-byte
    keys and each position's 3-gram candidate as the reference's c3 before
    its [hist:] slice; candidates3 reads the same c3 from the order."""
    rows = _rows(hist, 300 + hist + min3)
    data = _group(rows)[0]
    got = mk.sort_keys_plain(data, hist, min3)
    assert set(got) == ({"keys", "inv", "keys3", "inv3", "c3"} if min3
                        else {"keys", "inv"})
    for g, (kind, row, _, _) in enumerate(rows):
        for tag in ("", "3") if min3 else ("",):
            keys, order, h = _reference_order(row, tag == "3")
            have = got["keys" + tag][g].numpy().view(np.uint32) ^ (1 << 31)
            assert np.array_equal(have, keys), (kind, tag)
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size)
            assert np.array_equal(got["inv" + tag][g].numpy(), inv[hist:])
            if tag == "3":
                h3s = h[order]
                same3 = (np.roll(h3s, 1) == h3s) & (np.arange(order.size)
                                                    >= 1)
                c3 = np.zeros(order.size, np.int64)
                c3[order] = np.where(same3, np.roll(order, 1), -1)
                assert np.array_equal(got["c3"][g].numpy(), c3[hist:]), kind
    if min3:
        assert torch.equal(mk.candidates3(got["keys3"], got["inv3"]),
                           got["c3"])
    # The zero row is one hash bucket: its order is the positions'.
    zeros = [kind for kind, _, _, _ in rows].index("zeros")
    assert torch.equal(got["inv"][zeros].long(),
                       torch.arange(hist, data.shape[1] - td.PAD))


def test_sort_keys_on_cpu_is_the_plain_version(one_thread):
    data = _group(_rows(512, 17)[:3])[0]
    before = dict(kb.LAUNCHES)
    got = mk.sort_keys(data, 512, True)
    want = mk.sort_keys_plain(data, 512, True)
    assert kb.LAUNCHES == before
    assert set(got) == set(want) - {"c3"}
    assert all(torch.equal(got[key], want[key]) for key in got)
    with pytest.raises(ZippyError):
        mk.sort_keys(data.to(torch.int16))


def test_match_tokens_cuda_path_calls_no_library_sort():
    """K7 sorts its keys itself: neither wrapper's CUDA path, nor what it
    calls in the module, holds a torch sort, argsort or topk."""
    library = re.compile(r"torch\.sort|\.sort\(|argsort|topk|msort|kthvalue")
    for fn in (mk.match_tokens, mk.sort_keys, mk._sort_scratch, mk._call,
               mk._stream, mk._Args.of):
        assert not library.search(inspect.getsource(fn)), fn.__name__
    assert "torch.sort" not in (kb.CSRC / "match.cu").read_text()


def test_match_args_and_shapes_follow_match_cu():
    """The ctypes structure lists MatchArgs' pointers in the source's
    order, and the wrapper's scratch shapes and launch counts are the
    source's."""
    src = (kb.CSRC / "match.cu").read_text()
    body = re.search(r"struct MatchArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"void\* (\w+);", body)
    assert fields == [name for name, _ in mk._Args._fields_]

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\w+);", src)
                   .group(1), 0)

    assert const("kSortTile") == mk.SORT_TILE
    assert const("kChunk") == mk.CHUNK
    assert const("kExitStride") == mk.EXIT_STRIDE
    assert const("kPad") == mk.PAD
    sort = src[src.index("cudaError_t sort_keys("):]
    sort = sort[:sort.index("\n}\n")]
    tokens = src[src.index("int zt_match_tokens("):]
    tokens = tokens[:tokens.index("\n}\n")]
    assert sort.count("++*launched") == mk.LAUNCHES_SORT
    assert (mk.LAUNCHES_SORT + tokens.count("++*launched")
            == mk.LAUNCHES_PER_GROUP)
    kernels = set(re.findall(r"__global__ void __launch_bounds__\(\w+\)\n"
                             r"(\w+)\(", src))
    assert kernels and all(name.startswith("k7_") for name in kernels)

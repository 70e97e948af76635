"""zippy_tpu_torch's public compress() on the CPU, checked by CPython's gzip
and zlib and against zippy_tpu's framing."""

import gzip
import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zippy_tpu  # noqa: E402
import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu_torch import gzip_format  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402
from _torch_parity import mixed_payload, shared_depth  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("level", [-2, -1, 0, 1, 6, 9])
def test_compress_formats_decode(level):
    data = mixed_payload(3 * 4096 + 77, seed=31)
    g = zt.compress(data, level, zt.dfGzip, device="cpu")
    z = zt.compress(data, level, zt.dfZlib, device="cpu")
    r = zt.compress(data, level, zt.dfDeflate, device="cpu")
    assert gzip.decompress(g) == data
    assert zlib.decompress(z) == data
    assert zlib.decompress(r, wbits=-15) == data
    # Trailers equal zlib's checksums.
    assert int.from_bytes(g[-8:-4], "little") == zlib.crc32(data)
    assert int.from_bytes(g[-4:], "little") == len(data)
    assert int.from_bytes(z[-4:], "big") == zlib.adler32(data)
    assert z[:2] == b"\x78\x01"    # CINFO 7, CM 8, FLEVEL 0: the reference's


def test_gzip_member_framing_matches_reference():
    data = mixed_payload(5000, seed=37)
    got = gzip_format.write_member(data, 6, random_name_padding=False,
                                   device="cpu")
    ref = zippy_tpu.gzip_format.write_member(data, 6,
                                             random_name_padding=False,
                                             engine_name="device")
    assert got[:10] == ref[:10]
    assert got[-8:] == ref[-8:]
    assert gzip.decompress(got) == data
    padded = zt.compress(data, 6, zt.dfGzip, device="cpu")
    assert padded[3] & 0x08 and gzip.decompress(padded) == data   # FNAME


def _body(blob: bytes, fmt: str) -> bytes:
    """The raw DEFLATE body of a gzip, zlib or raw stream."""
    if fmt == "dfGzip":
        return blob[gzip_format.parse_header(blob)["data_offset"]:-8]
    return blob[2:-4] if fmt == "dfZlib" else blob


@pytest.mark.parametrize("fmt", ["dfGzip", "dfZlib", "dfDeflate"])
def test_default_level_runs_level_6_matcher_on_host_bytes(fmt, shared_depth):
    """Level -1 of host bytes runs level 6's matcher, as zippy_tpu's device
    route does; a tensor at -1 keeps level 1's (deflate_array)."""
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta",
             b"eta", b"theta", b"iota", b"kappa", b"lambda", b"mu"]
    rng = np.random.default_rng(43)
    data = b" ".join(words[i] for i in (rng.zipf(1.3, 3000) - 1) % 12)
    l1 = td.deflate(data, 1, device="cpu")
    l6 = td.deflate(data, 6, device="cpu")
    assert l1 != l6
    got = _body(zt.compress(data, -1, getattr(zt, fmt), device="cpu"), fmt)
    ref = _body(zippy_tpu.compress(data, -1, getattr(zippy_tpu, fmt),
                                   engine_name="device"), fmt)
    assert got == l6 == ref
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    assert _body(zt.compress(x, -1, getattr(zt, fmt)), fmt) == l1


def test_compress_inputs():
    data = "zippy torch text " * 300
    raw = data.encode()
    x = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    want = zt.compress(raw, 6, zt.dfDeflate, device="cpu")
    assert zt.compress(data, 6, zt.dfDeflate, device="cpu") == want
    assert zt.compress(bytearray(raw), 6, zt.dfDeflate, device="cpu") == want
    assert zt.compress(x, 6, zt.dfDeflate) == want        # a tensor stays put
    assert zt.compress(b"", 6, zt.dfDeflate, device="cpu") == b"\x03\x00"
    assert gzip.decompress(zt.compress(b"", 6, device="cpu")) == b""
    with pytest.raises(TypeError):
        zt.compress(12345, device="cpu")


def test_compress_rejects_what_the_port_lacks():
    # The host engine is part of the port: "native" is an engine it has.
    assert gzip.decompress(zt.compress(b"abc", 6, zt.dfGzip,
                                       engine_name="native",
                                       device="cpu")) == b"abc"
    with pytest.raises(zt.ZippyError):
        zt.compress(b"abc", 6, zt.dfGzip, engine_name="devcie", device="cpu")
    with pytest.raises(zt.ZippyError):
        zt.compress(b"abc", 6, zt.dfDetect, device="cpu")
    with pytest.raises(zt.ZippyError):
        zt.compress(b"abc", 11, device="cpu")
    for engine_name in ("auto", "device"):
        assert zlib.decompress(zt.compress(b"abc", 6, zt.dfZlib,
                                           engine_name=engine_name,
                                           device="cpu")) == b"abc"


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(zt.ZippyError):
        zt.compress(b"abc")
    with pytest.raises(zt.ZippyError):
        zt.compress(b"abc", 6, zt.dfZlib)


# Names of the reference that the port leaves out by design (ROADMAP.md,
# section A): none of them is in zippy_tpu.__all__ today, and the checks
# below stay true if one is added there.
LEFT_OUT_BY_DESIGN = {"default_mesh", "AXIS"}


def test_version_and_public_names_match_the_reference():
    assert zt.__version__ == zippy_tpu.__version__
    assert "__version__" in zt.__all__
    assert set(zt.__all__) == set(zippy_tpu.__all__) - LEFT_OUT_BY_DESIGN
    for name in zt.__all__:
        assert hasattr(zt, name), name


@pytest.mark.parametrize("module", ["engine", "gzip_format"])
def test_public_functions_match_the_reference(module):
    """Every public module-level function of zippy_tpu.engine and
    zippy_tpu.gzip_format has its namesake in the port."""
    import importlib
    import inspect

    ref = importlib.import_module(f"zippy_tpu.{module}")
    port = importlib.import_module(f"zippy_tpu_torch.{module}")
    names = {name for name, fn in inspect.getmembers(ref, inspect.isfunction)
             if fn.__module__ == ref.__name__ and not name.startswith("_")}
    assert {"read_member", "uncompress_gzip", "concat_members",
            "device_available", "is_device_array"} & names
    missing = {name for name in names - LEFT_OUT_BY_DESIGN
               if not inspect.isfunction(getattr(port, name, None))}
    assert not missing


def test_port_imports_neither_jax_nor_reference():
    """In a fresh interpreter (this one has jax loaded by conftest), the
    port and chip_smoke.py leave jax and zippy_tpu out of sys.modules."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import zippy_tpu_torch\n"
        "for m in pkgutil.walk_packages(zippy_tpu_torch.__path__, "
        "'zippy_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'zippy_tpu' or m.startswith('zippy_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_inflate_device_loads_no_container_module():
    """ops/inflate_device knows DEFLATE only: loaded in a fresh interpreter
    without the package's __init__ (which loads the whole API), it loads
    none of the modules that frame gzip, zlib, zip or tar."""
    code = (
        "import sys, types\n"
        "pkg = types.ModuleType('zippy_tpu_torch')\n"
        f"pkg.__path__ = [{str(REPO / 'zippy_tpu_torch')!r}]\n"
        "sys.modules['zippy_tpu_torch'] = pkg\n"
        "import zippy_tpu_torch.ops.inflate_device\n"
        "print(' '.join(m for m in sys.modules\n"
        "               if m.startswith('zippy_tpu_torch.')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = set(proc.stdout.split())
    assert "zippy_tpu_torch.ops.inflate_device" in loaded
    framing = {f"zippy_tpu_torch.{m}" for m in (
        "api", "gzip_format", "ziparchives", "ziparchives_v1", "tarballs",
        "tarballs_v1")}
    assert not loaded & framing, loaded & framing


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    for cwd in (REPO, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout

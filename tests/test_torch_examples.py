"""The port's CUDA examples (examples/cuda_*.py) run here on the CPU, each
given device "cpu" through its --device argument and a small input."""

import importlib.util
import pathlib
import tarfile
import zipfile

import pytest

pytest.importorskip("torch")

from _torch_parity import mixed_payload, one_thread  # noqa: E402,F401

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"

pytestmark = pytest.mark.usefixtures("one_thread")


def _main(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def test_cuda_ziparchive_create_and_extract(tmp_path):
    out = tmp_path / "example.zip"
    _main("cuda_ziparchive_create.py")([str(out), "--device", "cpu"])
    with zipfile.ZipFile(out) as zf:
        assert zf.read("file.txt") == b"Hello, Zip!"
    dest = tmp_path / "out"
    _main("cuda_ziparchive_extract.py")([str(out), str(dest), "--device",
                                         "cpu"])
    assert (dest / "data" / "blob.json").read_bytes() == b"{}"


def test_cuda_tarball_extract(tmp_path):
    src = tmp_path / "a.txt"
    src.write_bytes(mixed_payload(3000, 2))
    tgz = tmp_path / "t.tar.gz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(src, arcname="top/a.txt")
    dest = tmp_path / "out"
    _main("cuda_tarball_extract.py")([str(tgz), str(dest), "--device", "cpu"])
    assert (dest / "top" / "a.txt").read_bytes() == src.read_bytes()


@pytest.mark.parametrize("name", ["cuda_block_parallel.py",
                                  "cuda_device_inflate.py",
                                  "cuda_indexed_serving.py"])
def test_cuda_codec_examples(tmp_path, name, capsys):
    src = tmp_path / "in.bin"
    src.write_bytes(mixed_payload(5000, 4))
    _main(name)([str(src), "--device", "cpu"])    # each checks its output
    out = capsys.readouterr().out
    assert out and ("1 device(s)" in out or name != "cuda_block_parallel.py")


"""The port's multi-process layer (zippy_tpu_torch.parallel.distributed) run
for real: two ranks under torch.distributed with the gloo backend, each
compressing its shard block-parallel over two CPU devices, as
tests/test_distributed.py runs the reference's under jax.distributed.

compress_gzip_all_hosts must return the same stream on both ranks; CPython,
the port's uncompress and zippy_tpu's must decode it to the concatenation of
the shards; engine="native" (the reference's default) writes each rank's
member with the host engine and refuses a level outside -2..9 with
ZippyError; an unknown engine raises too.
"""

import gzip
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SHARDS = [b"rank zero payload " * 4000, b"rank one payload! " * 3000]

_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from zippy_tpu_torch.common import ZippyError
from zippy_tpu_torch.parallel import distributed
import torch.distributed as dist

rank = int(sys.argv[1])
distributed.initialize({coord!r}, 2, rank)
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
shards = {shards!r}
stream = distributed.compress_gzip_all_hosts(shards[rank], level=6,
                                             devices=["cpu"] * 2)
native = distributed.compress_gzip_all_hosts(shards[rank], engine="native",
                                             devices=["cpu"])
raised = []
for level, name in ((10, "native"), (6, "nativ")):
    try:
        distributed.compress_gzip_all_hosts(shards[rank], level, name,
                                            devices=["cpu"])
        raised.append("no error")
    except ZippyError:
        raised.append("ZippyError")
open({outdir!r} + f"/rank{{rank}}", "wb").write(stream)
open({outdir!r} + f"/rank{{rank}}.native", "wb").write(native)
open({outdir!r} + f"/rank{{rank}}.raised", "w").write(" ".join(raised))
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def streams():
    """Each rank's returned stream, its engine="native" stream and what
    raised there."""
    with tempfile.TemporaryDirectory() as outdir:
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        # The port picked by _free_port can be taken between close() and
        # the rendezvous: retry the two-rank launch on a fresh port then.
        for attempt in range(3):
            script = _WORKER.format(repo=str(REPO),
                                    coord=f"localhost:{_free_port()}",
                                    outdir=outdir, shards=SHARDS)
            procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                                      env=env, cwd=outdir,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE)
                     for r in range(2)]
            try:
                outs = [p.communicate(timeout=240) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if all(p.returncode == 0 for p in procs):
                break
            raced = any(b"Address already in use" in se for _, se in outs)
            if not (raced and attempt < 2):
                break
        for p, (_, se) in zip(procs, outs):
            assert p.returncode == 0, se.decode()[-2000:]
        yield [((Path(outdir) / f"rank{r}").read_bytes(),
                (Path(outdir) / f"rank{r}.native").read_bytes(),
                (Path(outdir) / f"rank{r}.raised").read_text())
               for r in range(2)]


def test_same_stream_on_both_ranks(streams):
    assert streams[0][0] == streams[1][0]


def test_cpython_decodes_the_concatenation(streams):
    assert gzip.decompress(streams[0][0]) == SHARDS[0] + SHARDS[1]


def test_port_and_reference_decode_it(streams):
    import zippy_tpu
    import zippy_tpu_torch
    from zippy_tpu_torch.parallel import distributed

    want = SHARDS[0] + SHARDS[1]
    stream = streams[0][0]
    assert zippy_tpu_torch.uncompress(stream, device="cpu") == want
    assert distributed.uncompress_gzip_all_hosts(stream, device="cpu") == want
    assert zippy_tpu.uncompress(stream, zippy_tpu.dfGzip) == want


def test_native_engine_raises(streams):
    """engine="native" raises ZippyError on level 10, which the host
    engine refuses, and an unknown engine raises too."""
    assert [r for _, _, r in streams] == ["ZippyError ZippyError"] * 2


def test_native_engine_writes_the_references_members(streams):
    """Under engine="native" each rank gets the host engine's members of
    both shards (zippy_tpu.native's bytes), in rank order."""
    from zippy_tpu import native

    want = native.gzip_compress(SHARDS[0], 1) + native.gzip_compress(
        SHARDS[1], 1)
    assert [n for _, n, _ in streams] == [want] * 2


def test_one_process_returns_its_member():
    from zippy_tpu_torch.parallel import blocks, distributed

    distributed.initialize(None, 1, 0)   # nothing for one process
    data = b"single process " * 500
    assert distributed.compress_gzip_all_hosts(data, 6, devices=["cpu"]) \
        == blocks.compress_gzip_sharded(data, 6, ["cpu"])

"""Driver entry points for zippy_tpu_torch: the port of __graft_entry__.py.

entry(device=None) — the one-block step: find_tokens, then the bit pack
with the fixed Huffman codes (deflate_device.compress_block_fixed) on one
64 KiB block, and its arguments on `device`.

dryrun_multichip(n_devices, devices=None) — the block-parallel compress
(parallel.deflate_sharded) of 2n small blocks over n devices, checked
against CPython's zlib and against the one-device stream, then the
multi-device decode (inflate_device with devices=) of that stream back to
the data.

A device list is the port's virtual mesh: ["cuda:0"] * n runs n shares on
one card, ["cpu"] * n the plain versions on the host. Nothing falls back to
the CPU unless the caller names it.

    python -m zippy_tpu_torch.entry     # both, on the CUDA cards
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from . import parallel
from .common import ZippyError, resolve_device, resolve_devices
from .ops import deflate_device as dd
from .ops import inflate_device as idev


def entry(device=None):
    """(step, args): step(*args) runs compress_block_fixed with k=4 and
    lazy matching on the reference's 64 KiB block (half "quick brown fox"
    text, half default_rng(0) noise) padded to BLOCK + PAD bytes; args are
    on `device` (None: the CUDA card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    text = (b"the quick brown fox jumps over the lazy dog. " * 800)[
        : dd.BLOCK // 2]
    noise = rng.integers(0, 256, dd.BLOCK - len(text)).astype(np.uint8)
    padded = np.zeros(dd.BLOCK + dd.PAD, np.uint8)
    padded[: dd.BLOCK] = np.concatenate([np.frombuffer(text, np.uint8),
                                         noise])

    def step(data_pad, n):
        return dd.compress_block_fixed(data_pad, n, k=4, lazy=True)

    return step, (torch.from_numpy(padded).to(dev),
                  torch.tensor(dd.BLOCK, dtype=torch.int64, device=dev))


def _dryrun_devices(n_devices: int, devices) -> list[torch.device]:
    if devices is not None:
        devices = resolve_devices(devices)
        if len(devices) != n_devices:
            raise ZippyError(f"dryrun_multichip({n_devices}) was given "
                             f"{len(devices)} devices")
        return devices
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n_devices:
        raise ZippyError(
            f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards and "
            f"this host has {count}; pass devices= an explicit list such as "
            f"{['cuda:0'] * n_devices!r}")
    return parallel.default_devices(n_devices)


def dryrun_multichip(n_devices: int, devices=None) -> tuple[bytes, bytes]:
    """The block-parallel compress of 2n blocks of 2 KiB (the reference's
    data: text and default_rng(7) noise in turns) over `devices` (None: the
    first n_devices CUDA cards; ZippyError when there are fewer), checked:
    CPython decodes the stream to the data, the stream equals the
    one-device stream, and the decode over the same devices gives the data
    back. Prints the reference's line; returns (data, stream)."""
    devices = _dryrun_devices(n_devices, devices)
    block_size = 2048
    rng = np.random.default_rng(7)
    parts = []
    for i in range(n_devices * 2):
        if i % 2 == 0:
            parts.append((b"zippy tpu block %d " % i) * 60)
        else:
            parts.append(rng.integers(0, 256, 1500).astype(np.uint8).tobytes())
    data = b"".join(p[:block_size] for p in parts)

    blob = parallel.deflate_sharded(data, 6, devices, block_size=block_size)
    if zlib.decompress(blob, wbits=-15) != data:
        raise ZippyError("sharded round trip failed")
    blob1 = parallel.deflate_sharded(data, 6, devices[:1],
                                     block_size=block_size)
    if blob != blob1:
        raise ZippyError("multi-device output differs from one device's")
    index = idev.build_decode_index(blob)
    if idev.inflate_device(blob, index, devices=devices) != data:
        raise ZippyError("sharded device decode differs from the input")
    print(f"dryrun_multichip({n_devices}): OK "
          f"({len(data)} -> {len(blob)} bytes, byte-identical to 1-chip; "
          f"sharded decode verified)")
    return data, blob


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry step:", [tuple(o.shape) for o in out])
    dryrun_multichip(min(8, torch.cuda.device_count()))

"""Multi-process compression over torch.distributed: the port of
zippy_tpu/parallel/distributed.py.

Each process compresses its local shard into one complete gzip member,
block-parallel over its own devices (parallel.blocks), and the members are
gathered to every process in rank order. Concatenated gzip members decode to
the concatenated payload (RFC 1952; CPython and the port agree), so the
gathered stream is a valid whole-dataset archive, the same on every rank.

Nothing on a host tells a process of its cluster: `initialize` takes the
coordinator's address, the world size and the rank. Failures propagate (no
elastic recovery), as in the reference.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import engine as engine_mod
from .. import gzip_format, native
from ..common import host_bytes
from . import blocks


def _default_backend(num_processes: int) -> str:
    """NCCL when this host has a card for every rank (rank r takes card
    r), else gloo: NCCL refuses two ranks on one card. Across hosts, pass
    the backend: every rank must choose the same one."""
    if (torch.cuda.is_available()
            and torch.cuda.device_count() >= num_processes):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join the process group at tcp://`coordinator_address` (host:port) as
    rank `process_id` of `num_processes`; nothing for one process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        backend or _default_backend(num_processes),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def _gather_device() -> torch.device:
    """Where the gather's tensors live: the rank's card under NCCL, the
    host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda",
                            dist.get_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def compress_gzip_all_hosts(local_data, level: int = 1,
                            engine: str = "device", devices=None) -> bytes:
    """Compress each process's shard into one gzip member (block-parallel
    over `devices`; None means the rank's own card under NCCL, else every
    card of this process) and return the members of every rank
    concatenated in rank order: the same stream on every process, after
    one gather of the lengths and one of the members padded to the
    longest. engine="native" (the reference's default) writes a shard of
    host bytes with the host engine instead, in one call (native.py); a
    tensor runs on its own device whatever the engine."""
    engine_mod.check_engine(engine)
    grouped = dist.is_initialized() and dist.get_world_size() > 1
    dev = _gather_device() if grouped else None
    if devices is None and grouped and dev.type == "cuda":
        devices = [dev]
    if engine_mod.on_host(local_data, engine):
        member = native.gzip_compress(host_bytes(local_data), level)
    else:
        member = blocks.compress_gzip_sharded(local_data, level, devices)
    if not grouped:
        return member
    world = dist.get_world_size()
    length = torch.tensor([len(member)], dtype=torch.int64, device=dev)
    lengths = [torch.empty_like(length) for _ in range(world)]
    dist.all_gather(lengths, length)
    lengths = [int(t) for t in lengths]
    padded = torch.zeros(max(lengths), dtype=torch.uint8)
    padded[:len(member)] = torch.frombuffer(bytearray(member),
                                            dtype=torch.uint8)
    padded = padded.to(dev)
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return b"".join(part[:n].cpu().numpy().tobytes()
                    for part, n in zip(parts, lengths))


def uncompress_gzip_all_hosts(stream: bytes, device=None) -> bytes:
    """Decode a multi-member stream from compress_gzip_all_hosts through
    the port's gzip decode on `device` (None: the CUDA card)."""
    return gzip_format.uncompress_gzip_device_all(stream, device)

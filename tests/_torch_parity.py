"""Helpers shared by the tests that hold zippy_tpu_torch against zippy_tpu."""

import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zippy_tpu.ops import deflate_device as jd
from zippy_tpu_torch.ops import deflate_device as td


def raw_deflate(data: bytes, level: int = 6, *, mem_level: int = 8,
                strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    """A raw DEFLATE stream from CPython's zlib (a small mem_level makes
    many blocks; zlib.Z_FIXED fixed-Huffman ones)."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15, mem_level, strategy)
    return c.compress(data) + c.flush()


def random_bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


DEEP_CHAINS = b"a" * 100_000 + b"bc" * 5_000 + b"a" * 50_000


def mixed_payload(n: int, seed: int = 3) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < n:
        kind = rng.integers(0, 3)
        if kind == 0:
            parts.append(b"the quick brown fox " * int(rng.integers(1, 20)))
        elif kind == 1:
            parts.append(bytes(rng.integers(0, 256, int(rng.integers(10, 400)))))
        else:
            parts.append(bytes([int(rng.integers(0, 256))])
                         * int(rng.integers(5, 300)))
    return b"".join(parts)[:n]


class SharedDepth(types.SimpleNamespace):
    """Stands in for `jnp` inside the reference module: `log2` becomes a
    host callback to the port's `_ideal_depth`; every other name is jnp's."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def log2(x):
        def host(v):
            r = torch.from_numpy(np.asarray(v, np.float32).copy())
            return td._ideal_depth(r).numpy()

        return jax.pure_callback(host, jax.ShapeDtypeStruct(x.shape,
                                                            jnp.float32),
                                 x, vmap_method="expand_dims")


@pytest.fixture
def shared_depth(monkeypatch):
    """Both encoders on the port's ideal depths. The jit caches are cleared
    around the swap, so no trace of either version outlives the test."""
    jax.clear_caches()
    monkeypatch.setattr(jd, "jnp", SharedDepth())
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.fixture
def one_thread():
    """Torch ops on one thread for the test. The suite runs in several
    worker processes on the host's cores, and torch's per-op thread pools
    spinning against each other made the decode tests several times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""Encode groups for K10 (join_kernels.join_rows) and its plain version,
built from row specifications rather than encoded: the join reads a row as
bits (its mode, its header and payload bit counts and words, a stored
row's bytes), so random bits in the shapes the encoder gives test it as
well as real blocks do. Shared by tests/test_torch_join.py (the plain
version against the host splice) and tests/test_torch_join_card.py (K10
against the plain version); imports no jax.

A row is (mode, payload bits, header bits, block bytes): mode 0 stored, 1
fixed, 2 dynamic. Words past a row's payload bits and header words past
its header bits are zero, as K8 and K5 leave them; a row of more bits than
its words hold (a group the join must refuse) fills them all."""

import numpy as np
import torch

from zippy_tpu_torch.ops import join_kernels as jk
from zippy_tpu_torch.ops.huffman_kernels import HDR_WORDS

BLOCK = 2048            # the groups' block size, but where a case says
OFFSET = 96             # bytes of each row before its block (its history)
PAD = 40                # bytes of each row after its block
HEADER_MAX = 2283       # the longest dynamic header, 14 + 3 * 19 + 7 * 316


def group(rows: list, seed: int, block: int = BLOCK) -> dict:
    """The join's inputs for `rows`: res (mode, nbits, hdr_bits, hdr_words,
    words as deflate_device._encode_group gives them), lens, raw, offset,
    block_size."""
    rng = np.random.default_rng(seed)
    g, wn = len(rows), block // 2 + 8
    words = np.zeros((g, wn), np.uint32)
    hdr = np.zeros((g, HDR_WORDS), np.uint32)
    for j, (mode, nb, hb, _) in enumerate(rows):
        for arr, bits in ((words, nb if mode else 0),
                          (hdr, hb if mode == 2 else 0)):
            full, rest = divmod(min(bits, 32 * arr.shape[1]), 32)
            arr[j, :full] = rng.integers(0, 1 << 32, full, dtype=np.uint64)
            if rest:
                arr[j, full] = rng.integers(0, 1 << rest)
    raw = rng.integers(0, 256, (g, OFFSET + block + PAD), dtype=np.uint8)
    col = lambda k: torch.tensor([r[k] for r in rows], dtype=torch.int64)
    return {"res": {"mode": col(0), "nbits": col(1), "hdr_bits": col(2),
                    "hdr_words": torch.from_numpy(hdr.view(np.int32)),
                    "words": torch.from_numpy(words.view(np.int32))},
            "lens": col(3), "raw": torch.from_numpy(raw),
            "offset": OFFSET, "block_size": block}


def _fixed(nb: int, n: int = 700) -> tuple:
    return (1, nb, 0, n)


def _dynamic(nb: int, hb: int, n: int = 1500) -> tuple:
    return (2, nb, hb, n)


def _stored(n: int) -> tuple:
    return (0, 8 * n + 40, 0, n)    # a stored row's payload is not read


def cases(phase: int) -> dict:
    """{name: (rows, block size, the row of the stream's last block)} for a
    group that starts at `phase`."""
    # Row 0 ends on a word boundary of the piece, and so does row 1.
    word_end = [_fixed(64 - 3 - phase), _dynamic(96 - 3 - 71, 71), _fixed(7)]
    return {
        "stored": ([_stored(300), _stored(1), _stored(BLOCK), _stored(77)],
                   BLOCK, -1),
        "fixed": ([_fixed(1234), _fixed(5), _fixed(9000), _fixed(31)],
                  BLOCK, -1),
        "dynamic": ([_dynamic(4000, 1777), _dynamic(1, HEADER_MAX),
                     _dynamic(12000, 14 + 57 + 33)], BLOCK, -1),
        "mixed": ([_dynamic(4000, 999), _stored(513), _fixed(7),
                   _stored(1000), _dynamic(8, 71), _fixed(333)], BLOCK, -1),
        # Two stored chunks: 65,535 bytes and 1.
        "stored_two_chunks": ([_fixed(77), _stored(65536), _fixed(90)],
                              65536, -1),
        "final_stored": ([_fixed(99), _stored(65536)], 65536, 1),
        "final_fixed": ([_stored(40), _fixed(2000)], BLOCK, 1),
        "final_dynamic": ([_fixed(40), _dynamic(2001, 500)], BLOCK, 1),
        "end_of_block_only": ([_fixed(7), _fixed(7), _fixed(7)], BLOCK, 2),
        "word_end": (word_end, BLOCK, -1),
        "one_row": ([_dynamic(5555, 1234)], BLOCK, 0),
        "rows_64": (random_rows(64, 1000 + phase), BLOCK, 63),
    }


def random_rows(g: int, seed: int, block: int = BLOCK) -> list:
    """g rows of seeded random modes and sizes, each within the piece's
    bound (join_kernels.row_bytes)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(g):
        mode, n = int(rng.integers(0, 3)), int(rng.integers(1, block + 1))
        if mode == 0:
            rows.append(_stored(n))
            continue
        hb = int(rng.integers(14 + 57, HEADER_MAX + 1)) if mode == 2 else 0
        most = 8 * jk.row_bytes(block) - 16 - hb
        rows.append((mode, int(rng.integers(7, most)), hb, n))
    return rows


def join(data: dict, last: int, phase: int, device=None):
    """join_kernels.join_rows of a case's group (on `device`, None: the
    CPU) from `phase`: (the piece's bytes up to its last bit, the state row
    of its join), both on the CPU."""
    to = (lambda t: t) if device is None else (lambda t: t.to(device))
    res = {k: to(v) for k, v in data["res"].items()}
    state = to(jk.new_state(1, "cpu"))
    state[0, jk.PHASE] = phase
    piece = jk.join_rows(res, to(data["lens"]), to(data["raw"]),
                         data["offset"], data["block_size"], last, state, 0)
    row = state[1].cpu()
    nbytes = (phase + int(row[jk.BITS]) + 7) // 8
    return piece[:nbytes].cpu(), row

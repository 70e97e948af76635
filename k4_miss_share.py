"""Count how often K4's first-level tables miss, on the host.

    python3 k4_miss_share.py

K4 (zippy_tpu_torch/csrc/inflate.cu) decodes a litlen code of at most
inflate_kernels.FAST_BITS bits from its first-level table and a longer one
by compares; a warp of 32 lanes runs the compares whenever one of its lanes
needs them. This script takes a 2 MiB prefix of chip_smoke.py's seeded
payload, compresses it with CPython's zlib at level 6, extracts every
token with K4's plain version on the CPU, and prints one JSON line: the
tokens, the share of them whose litlen code is longer than FAST_BITS bits,
and the share of 32-lane warp-steps that hold at least one such token.
These are counts of the data, not times; no card is needed.
"""

from __future__ import annotations

import json
import sys
import zlib

import numpy as np
import torch

import chip_smoke
from zippy_tpu_torch.ops import inflate_device as idev
from zippy_tpu_torch.ops import inflate_kernels as ik

_LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
     67, 83, 99, 115, 131, 163, 195, 227, 258])


def main() -> int:
    data = chip_smoke.mixed_text(2 << 20, chip_smoke.SEED)
    blob = zlib.compress(data, 6)[2:-4]
    index = idev.build_decode_index(blob)
    cfg = idev._pick_cfg(index["total_out"])
    tiles = idev._plan_tiles(index, cfg)
    packs = torch.from_numpy(np.stack([
        idev._tile_pack(blob, index, t, cfg, idev._nrounds_for_depth(
            t.depth, cfg)) for t in tiles]).view(np.int32))
    words, seg, _, lens8 = idev._unpack(packs, cfg)
    used = [t.s1 - t.s0 for t in tiles]
    tok = ik.inflate_extract(words, seg, used, idev._block_tables(
        lens8.reshape(-1, 318)), index["every"]).numpy()     # (k, lanes)
    # Each lane's block: its tile's first block plus its block row.
    tile_of = np.repeat(np.arange(len(used)), used)
    lane = np.concatenate([np.arange(u) for u in used])
    blk = seg[torch.from_numpy(tile_of), 1, torch.from_numpy(lane)].numpy()
    lens = index["block_lens"][blk + np.array([t.b0 for t in tiles])[
        tile_of]][:, :288].astype(np.int64)                 # (lanes, 288)
    valid = tok != 0
    low, length = tok & 0xFFFF, tok >> 16
    match = valid & (low >= 256)
    # The litlen symbol: the literal, or 257 + the length's code.
    sym = np.where(match, 257 + np.searchsorted(
        _LENGTH_BASE, np.where(match, length, 3), side="right") - 1,
        np.where(valid, low, 0))
    code_len = np.take_along_axis(lens, sym.T, axis=1).T
    miss = valid & (code_len > ik.FAST_BITS)
    n = miss.shape[1] // 32 * 32
    warp_steps = miss[:, :n].reshape(miss.shape[0], -1, 32).any(axis=-1)
    print(json.dumps({"payload_bytes": len(data), "tokens": int(valid.sum()),
                      "matches": int(match.sum()),
                      "litlen_longer_than_fast_bits": float(
                          miss.sum() / valid.sum()),
                      "warp_steps_with_one": float(warp_steps.mean())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

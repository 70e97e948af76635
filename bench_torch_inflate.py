"""Time zippy_tpu_torch's token extraction kernel K4 on one CUDA card.

    python3 bench_torch_inflate.py [--root DIR] [--reps N]

Imports zippy_tpu_torch from DIR (default: this checkout), so two trees can
be compared in one run on one card, e.g. an unpacked `git archive` of a
parent commit against this one, in turns: parent, this, this, parent. The
stream is CPython's zlib level 6 of chip_smoke.py's seeded 64 MiB payload,
the same bytes whatever the tree. Every tile's K4 inputs are made as the
tree's decode makes them; then the launches over all tiles (one per batch
of tiles where the tree batches them, `inflate_device._TILES_PER_LAUNCH`,
else one per tile) are captured in one CUDA graph, `reps` times, and
replayed between CUDA events. Prints one JSON line: the tree, the card,
the tiles, the launches, the device ms for all tiles and per tile, and
whether K4 equals its plain version on every tile. Exits non-zero without
a CUDA card or when it does not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

import numpy as np
import torch

import chip_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_inflate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from zippy_tpu_torch.ops import inflate_device as idev
    from zippy_tpu_torch.ops import inflate_kernels as ik

    dev = torch.device("cuda")
    data = chip_smoke.mixed_text(chip_smoke.MAIN_BYTES, chip_smoke.SEED)
    blob = zlib.compress(data, 6)
    index = idev.build_decode_index(blob, 16)
    cfg = idev._pick_cfg(index["total_out"])
    k = index["every"]
    tiles = idev._plan_tiles(index, cfg)
    packs = [idev._tile_pack(blob, index, t, cfg,
                             idev._nrounds_for_depth(t.depth, cfg))
             for t in tiles]
    launches, equal = [], True
    if hasattr(idev, "_TILES_PER_LAUNCH"):
        cap = idev._TILES_PER_LAUNCH
        for b in range(0, len(tiles), cap):
            p = torch.from_numpy(np.stack(packs[b:b + cap]).view(
                np.int32)).to(dev)
            words, seg, *_, lens8 = idev._unpack(p, cfg)
            used = [t.s1 - t.s0 for t in tiles[b:b + cap]]
            tables = idev._block_tables(lens8.reshape(-1, 318))
            bases, ncta = ik._bases(used, dev)
            out = ik.inflate_extract(words, seg, used, tables, k)
            equal &= bool(torch.equal(out, ik._extract_plain(
                words, seg, used, tables, k)))
            launches.append(lambda a=(words, seg, bases, ncta, tables, k,
                                      out): ik._launch(*a))
    else:
        for pack in packs:
            p = torch.from_numpy(pack.view(np.int32)).to(dev)
            words, bit, blk, ntok, _, lens8 = idev._unpack(p, cfg)
            a = (words, bit, blk, ntok, idev._block_tables(lens8), k)
            equal &= bool(torch.equal(ik.inflate_extract(*a),
                                      ik._extract_plain(*a)))
            launches.append(lambda a=a: ik.inflate_extract(*a))

    def run_all():
        for launch in launches:
            launch()

    ms = chip_smoke.kernel_ms(run_all, args.reps)
    print(json.dumps({"root": args.root, "module": ik.__file__,
                      "card": chip_smoke.card_line(), "tiles": len(tiles),
                      "launches": len(launches), "ms": ms,
                      "ms_per_tile": ms / len(tiles), "equal_plain": equal}),
          flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())

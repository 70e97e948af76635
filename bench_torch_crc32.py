"""Time zippy_tpu_torch's whole crc32_device call on one CUDA card.

    python3 bench_torch_crc32.py [--root DIR] [--reps N]

Imports zippy_tpu_torch from DIR (default: this checkout), so two trees can
be compared in one run on one card, e.g. an unpacked `git archive` of a
parent commit against this one, in turns: parent, this, this, parent.
Prints one JSON line: the tree, the card, and for a 64 MiB aligned payload
and a 256 MiB + 7 one (random, made on the card from a seed) the host-clock
ms per synchronized call and the device operations one call launches
(chip_smoke.crc32_call). Exits non-zero without a CUDA card or when a
result differs from zlib.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

import torch

import chip_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_crc32: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from zippy_tpu_torch.ops import checksums as tc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    calls = []
    for n in (chip_smoke.MAIN_BYTES, (256 << 20) + 7):
        x = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                          generator=gen)
        line = chip_smoke.crc32_call(tc, x, args.reps)
        line["equal_zlib"] = (tc.crc32_device(x)
                              == zlib.crc32(x.cpu().numpy().tobytes()))
        calls.append(line)
        del x
    print(json.dumps({"root": args.root, "module": tc.__file__,
                      "card": chip_smoke.card_line(), "calls": calls}),
          flush=True)
    return 0 if all(c["equal_zlib"] for c in calls) else 1


if __name__ == "__main__":
    sys.exit(main())

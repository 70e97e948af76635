"""Time zippy_tpu_torch's whole crc32_device call, and its row fold K3
alone, on one CUDA card.

    python3 bench_torch_crc32.py [--root DIR] [--reps N] [--max-lgs 4,3]

Imports zippy_tpu_torch from DIR (default: this checkout), so two trees can
be compared in one run on one card, e.g. an unpacked `git archive` of a
parent commit against this one, in turns: parent, this, this, parent.
Prints one JSON line: the tree, the card, and for a 64 MiB aligned payload
and a 256 MiB + 7 one (random, made on the card from a seed) the host-clock
ms per synchronized call and the device operations one call launches
(chip_smoke.crc32_call); then K3 alone (chip_smoke.kernel_ms, 100 launches
in a CUDA graph) on each payload's row CRCs (131072 rows; 524289 with a
7-byte last row), beside the launch floor (chip_smoke.launch_floor_ms).
The time is that of the tree's `crc_combine` wrapper, whatever it launches:
a wrapper that zero-fills its output before K3 is timed with its fill.
`--max-lgs` times K3 again with each cap on log2 of its blocks
(`checksum_kernels.COMBINE_MAX_LG`, trees whose wrapper passes it to K3).
Exits non-zero without a CUDA card or when a result differs from zlib or
from the plain version.
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
    ap.add_argument("--max-lgs", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_crc32: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from zippy_tpu_torch.ops import checksum_kernels as ck
    from zippy_tpu_torch.ops import checksums as tc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    calls, combine, ok = [], [], True
    for n in (chip_smoke.MAIN_BYTES, (256 << 20) + 7):
        x = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                          generator=gen)
        line = chip_smoke.crc32_call(tc, x, args.reps)
        line["equal_zlib"] = (tc.crc32_device(x)
                              == zlib.crc32(x.cpu().numpy().tobytes()))
        ok &= line["equal_zlib"]
        calls.append(line)
        full = n // ck.CRC_ROW_BYTES
        rows = ck.crc_rows(x[:full * ck.CRC_ROW_BYTES].view(
            full, ck.CRC_ROW_BYTES), x[full * ck.CRC_ROW_BYTES:])
        last = n - full * ck.CRC_ROW_BYTES or ck.CRC_ROW_BYTES
        caps = [None] + [int(v) for v in args.max_lgs.split(",") if v]
        for cap in caps:
            keep = ck.COMBINE_MAX_LG
            if cap is not None:
                ck.COMBINE_MAX_LG = cap
            try:
                equal = bool(torch.equal(ck.crc_combine(rows, last),
                                         ck.crc_combine_plain(rows, last)))
                ms = chip_smoke.kernel_ms(
                    lambda: ck.crc_combine(rows, last), 100)
            finally:
                ck.COMBINE_MAX_LG = keep
            ok &= equal
            combine.append({"rows": rows.numel(), "last_bytes": last,
                            "max_lg": keep if cap is None else cap,
                            "ms": ms, "equal_plain": equal})
        del x, rows
    print(json.dumps({"root": args.root, "module": tc.__file__,
                      "card": chip_smoke.card_line(), "calls": calls,
                      "crc_combine": combine,
                      "launch_floor_ms": chip_smoke.launch_floor_ms(dev)}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

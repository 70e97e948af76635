"""How often a torch.profiler trace of one crc32_device call on an unaligned
64 MiB CUDA view misses a device operation, with no host margin around the
call and with chip_smoke.TRACE_MARGIN_S on either side.

    python3 trace_window_check.py [--rounds N]

The call runs 4 device operations (the aligned copy, K2, K3, the 4-byte copy
of the raw CRC); each round traces it once without the margin and once with
it, in turns. Prints one JSON line: per setting, how many traces saw each
count of device operations, and the device ms of the traces that missed
one (which operation went missing shows in its time: the aligned copy takes
about 0.06 ms of the call's 0.11 ms on an H100).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

import chip_smoke


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=200)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("trace_window_check: no CUDA device", file=sys.stderr)
        return 2
    from zippy_tpu_torch.ops import checksums as tc

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    x = torch.randint(0, 256, (chip_smoke.MAIN_BYTES + 1,),
                      dtype=torch.uint8, device="cuda", generator=gen)[1:]
    tc.crc32_device(x)
    margin = chip_smoke.TRACE_MARGIN_S
    seen = {"no_margin": {}, "margin": {}}
    short_ms = {"no_margin": [], "margin": []}
    for _ in range(args.rounds):
        for name, m in (("no_margin", 0.0), ("margin", margin)):
            chip_smoke.TRACE_MARGIN_S = m
            t = chip_smoke.device_trace(lambda: tc.crc32_device(x))
            ops = t["device_ops"]
            seen[name][ops] = seen[name].get(ops, 0) + 1
            if ops != 4:
                short_ms[name].append(None if t["device_busy_s"] is None
                                      else t["device_busy_s"] * 1e3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "rounds": args.rounds, "margin_s": margin,
                      "device_ops_seen": {k: {str(o): n for o, n in v.items()}
                                          for k, v in seen.items()},
                      "missing_traces_device_ms": short_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

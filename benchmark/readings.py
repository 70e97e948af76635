"""The readings that the limits of `correct` are set from: one cell on the
CUDA card, in one process, on each of several seeds, as the program
(--impl program), as the control (--impl control: the reference in the
program's place, at the configuration's `control_level` for a compress
cell, with one byte changed for a decode), or both in turns. A window of
--seconds at the cell's own load each time.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 \
        --seconds 5 --impl both

Prints one JSON line a run: the seed, the implementation, correct, the
calls, and the numbers compared with their limits.
"""

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--impl", choices=("program", "control", "both"),
                   default="both")
    args = p.parse_args(argv)
    impls = ("program", "control") if args.impl == "both" else (args.impl,)
    bench = harness.Bench()
    for seed in (int(s) for s in args.seeds.split(",")):
        for impl in impls:
            try:
                result, _ = harness.run_cell(
                    bench, args.workload, seed, args.seconds, False,
                    t0=time.perf_counter(), impl=impl)
            except harness.NoDevice as exc:
                print(f"readings.py: {exc}", file=sys.stderr)
                return 2
            print(json.dumps({"seed": seed, "impl": impl,
                              "correct": result["correct"],
                              "attempted": result["attempted"],
                              "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

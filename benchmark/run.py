"""Run one cell of the benchmark of zippy_tpu_torch on the CUDA card(s) of this
machine, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints as the last line of standard output one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and last the
checks, each number compared beside its limit), and ends standard error with
the same checks. With --trace 0 the metrics are the cell's end-to-end
metrics, with --trace 1 its per-layer ones. Without the card(s) the cell
asks for it prints no result and exits with 2; if the run loaded JAX or the
JAX package it prints no result and exits with 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result, checks = harness.run_cell(
            harness.Bench(), args.workload, args.seed, args.seconds,
            bool(args.trace), t0=T0)
    except harness.NoDevice as exc:
        print(f"run.py: {exc}; nothing was run", file=sys.stderr)
        return 2
    loaded = harness.forbidden_modules()
    if loaded:
        print("run.py: the run loaded " + ", ".join(loaded), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("\n".join(checks), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Block-parallel compression over the CUDA cards: the port's counterpart
of examples/tpu_block_parallel.py (see zippy_tpu_torch/parallel/). Each
card encodes a contiguous run of blocks; the stream is byte-identical to
the one-card encode.

Run: python examples/cuda_block_parallel.py [file] [--device cpu]
"""

import argparse
import gzip
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from zippy_tpu_torch import parallel


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file", nargs="?")
    ap.add_argument("--device", default=None,
                    help="one torch device (default: every CUDA card)")
    args = ap.parse_args(argv)
    data = pathlib.Path(args.file).read_bytes() if args.file else (
        b"block parallel compression demo " * 100000)
    devices = None if args.device is None else [args.device]
    blob = parallel.compress_gzip_sharded(data, level=6, devices=devices)
    assert gzip.decompress(blob) == data
    n = len(devices or parallel.default_devices())
    print(f"{n} device(s): {len(data)} -> {len(blob)} bytes")


if __name__ == "__main__":
    main()

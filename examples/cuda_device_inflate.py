"""Device-parallel decompression on the CUDA card: the port's counterpart
of examples/tpu_device_inflate.py (see zippy_tpu_torch/ops/inflate_device.py).

A one-time host scan indexes token boundaries (the rapidgzip model), then
every segment Huffman-decodes concurrently on the card (kernel K4) and the
LZ back-references resolve in pointer-doubling rounds. The stream stays
standard RFC 1951: the index is auxiliary and reusable, so repeated decodes
of the same stream skip the scan.

Run: python examples/cuda_device_inflate.py [file] [--device cpu]
"""

import argparse
import pathlib
import sys
import zlib

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from zippy_tpu_torch.ops import inflate_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file", nargs="?")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    raw = pathlib.Path(args.file).read_bytes() if args.file else (
        b"device parallel inflate demo " * 50000)
    blob = zlib.compress(raw, 6)[2:-4]  # any producer's raw DEFLATE stream

    index = inflate_device.build_decode_index(blob)   # one-time host scan
    out = inflate_device.inflate_device(blob, index, device=args.device)
    assert out == raw
    print(f"{len(blob)} compressed -> {len(out)} bytes on "
          f"{index['segments'].shape[0]} parallel segments, "
          f"{index['block_lens'].shape[0]} block table(s)")


if __name__ == "__main__":
    main()

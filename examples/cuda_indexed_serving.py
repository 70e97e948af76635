"""Scan-free serving on the CUDA card with encode-time decode indexes: the
port's counterpart of examples/tpu_indexed_serving.py.

compress_device_indexed embeds each gzip member's full decode index in
sidecar members that standard readers see as empty, so uncompress_device
feeds the tiled decode directly, with no host scan, and checks every
member's adler32 and crc32 on the card with one fetch. Any gzip reader
(CPython, zcat) decodes the same bytes unchanged.

Run: python examples/cuda_indexed_serving.py [file] [--device cpu]
"""

import argparse
import gzip
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import zippy_tpu_torch as zt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file", nargs="?")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    src = pathlib.Path(args.file).read_bytes() if args.file else (
        b"scan-free indexed serving demo " * 200000)

    t0 = time.perf_counter()
    blob = zt.compress_device_indexed(src, 6, device=args.device)
    print(f"compressed+indexed {len(src)} -> {len(blob)} bytes "
          f"({time.perf_counter() - t0:.2f}s)")
    # Standard readers see a normal gzip stream (sidecars decode to b"").
    assert gzip.decompress(blob) == src

    # The decoded members stay on the device for a consumer there.
    t0 = time.perf_counter()
    parts = zt.uncompress_device(blob, array=True, device=args.device)
    print(f"device decode (no host scan): {len(parts)} member(s) in "
          f"{time.perf_counter() - t0:.2f}s")
    got = b"".join(buf.cpu().numpy().tobytes() for buf, _ in parts)
    assert got == src
    print("round-trip verified")


if __name__ == "__main__":
    main()

"""In-memory zip creation on the CUDA card: the port's counterpart of
examples/ziparchive_create.py. Every entry is encoded in one batched device
call (shared groups of blocks) and every crc32 comes from one fetch.

Run: python examples/cuda_ziparchive_create.py [out.zip] [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import zippy_tpu_torch as zt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="example.zip")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    entries = {
        "file.txt": "Hello, Zip!",
        "data/blob.json": "{}",
    }
    blob = zt.create_zip_archive(entries, device=args.device)
    pathlib.Path(args.out).write_bytes(blob)
    print(f"wrote {args.out} ({len(blob)} bytes)")


if __name__ == "__main__":
    main()

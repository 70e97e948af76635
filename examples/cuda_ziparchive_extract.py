"""Extract a zip archive on the CUDA card: the port's counterpart of
examples/ziparchive_extract.py. The deflated entries decode in one
dispatch pass, their checksums come back in one fetch, and the files are
written once every check has passed.

Run: python examples/cuda_ziparchive_extract.py archive.zip dest [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import zippy_tpu_torch as zt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archive")
    ap.add_argument("dest")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    zt.extract_all_zip(args.archive, args.dest, device=args.device)


if __name__ == "__main__":
    main()

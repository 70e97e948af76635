"""Extract a tarball on the CUDA card (a .tar.gz decodes there): the
port's counterpart of examples/tarball_extract.py.

Run: python examples/cuda_tarball_extract.py archive.tar.gz dest [--device cpu]
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
    zt.extract_all_tarball(args.archive, args.dest, device=args.device)


if __name__ == "__main__":
    main()

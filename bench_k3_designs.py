"""Time K3 (the crc32 row fold) in the designs that were measured and not
kept, beside the kept one, on one CUDA card.

    python3 bench_k3_designs.py

Builds bench_k3/cluster.cu (a cluster of up to 16 blocks of 512 threads,
and a cooperative grid of up to 128) and bench_k3/ticket.cu (up to 128
blocks of 256 threads meeting through a ticket, with nibble or byte
tables) with nvcc into build/bench_k3/, all started together. On random
row CRCs of 1 to 2097153 rows (a last row of 77 bytes; 131072 rows with a
full one) it checks every design against zippy_tpu_torch's plain version
and times it as chip_smoke.kernel_ms does (100 launches in a CUDA graph):
one JSON line per design, {"design": ..., "<rows>/<log2 blocks>": us}, the
kept design's (checksum_kernels.crc_combine) first. Then the launch floor
(chip_smoke.launch_floor_ms) and the card. Exits non-zero without a CUDA
card, when a build fails or when a result differs from the plain version.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS = (1, 1025, 16385, 131072, 524289, 2097153)
# name: (source, nvcc defines, threads, largest log2 of blocks, rows a lane)
DESIGNS = {
    "cluster": ("cluster.cu", ["-DTHREADS=512", "-DCOOP=0"], 512, 4, 1),
    "cooperative": ("cluster.cu", ["-DTHREADS=512", "-DCOOP=1"], 512, 7, 1),
    "ticket": ("ticket.cu", ["-DTHREADS=256", "-DNIB=1"], 256, 7, 4),
    "ticket_byte_tables": ("ticket.cu", ["-DTHREADS=256", "-DNIB=0"], 256, 7,
                           4),
}


def build() -> dict:
    out = os.path.join(ROOT, "build", "bench_k3")
    os.makedirs(out, exist_ok=True)
    procs = {name: subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", *defines,
         "-o", os.path.join(out, name + ".so"),
         os.path.join(ROOT, "bench_k3", src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, defines, *_) in DESIGNS.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"bench_k3_designs: {name} did not build:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, name + ".so"))
        p = ctypes.c_void_p
        lib.zt_k3.argtypes = ([p, ctypes.c_longlong, ctypes.c_int, p, p]
                              + ([ctypes.c_int] if name.startswith("ticket")
                                 else [p]) + [p, p])
        lib.zt_k3.restype = ctypes.c_int
        libs[name] = lib
    return libs


def columns(name: str, threads: int, lg: int, last: int, tc) -> np.ndarray:
    """The host columns a design takes: the cluster's meeting matrix of each
    block (the shift over the blocks after it and the last row), else the
    shift over the last row."""
    if name != "cluster":
        return np.ascontiguousarray(tc._shift_cols(last), dtype=np.uint32)
    block = tc._shift_cols(512 * threads)
    cols = [tc._shift_cols(last)]
    for _ in range((1 << lg) - 1):
        cols.append(tc._apply_cols(cols[-1], block))
    return np.ascontiguousarray(np.stack(cols[::-1]), dtype=np.uint32)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_k3_designs: no CUDA device", file=sys.stderr)
        return 2
    from zippy_tpu_torch.ops import checksum_kernels as ck
    from zippy_tpu_torch.ops import checksums as tc

    libs = build()
    dev = torch.device("cuda")
    levels = torch.from_numpy(tc.crc_shift_tables(27).ravel().view(
        np.int32).copy()).to(dev)
    sums = torch.empty(128, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    inputs = []
    for n in ROWS:
        c = torch.randint(0, 1 << 32, (n,), dtype=torch.int64, device=dev,
                          generator=gen).to(torch.int32)
        last = 512 if n == 131072 else 77
        inputs.append((n, c, last, ck.crc_combine_plain(c, last)))
    ok = True
    row = {"design": "kept", "source": ck.__file__}
    for n, c, last, want in inputs:
        ok &= bool(torch.equal(ck.crc_combine(c, last), want))
        row[f"{n}/{ck._combine_lg(n - 1)}"] = 1e3 * chip_smoke.kernel_ms(
            lambda: ck.crc_combine(c, last), 100)
    print(json.dumps(row), flush=True)
    for name, (_, _, threads, max_lg, per_lane) in DESIGNS.items():
        row = {"design": name}
        for n, c, last, want in inputs:
            lg = 0
            while lg < max_lg and (threads << lg) * per_lane < n - 1:
                lg += 1
            cols = columns(name, threads, lg, last, tc)
            out = torch.empty(1, dtype=torch.int32, device=dev)
            third = 3 if name.startswith("ticket") else sums.data_ptr()

            def launch():
                rc = libs[name].zt_k3(
                    c.data_ptr(), n, lg, levels.data_ptr(), cols.ctypes.data,
                    third, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"bench_k3_designs: {name}: error {rc}")

            launch()
            ok &= bool(torch.equal(out, want))
            row[f"{n}/{lg}"] = 1e3 * chip_smoke.kernel_ms(launch, 100)
            ok &= bool(torch.equal(out, want))
        print(json.dumps(row), flush=True)
    print(json.dumps({"launch_floor_us": 1e3 * chip_smoke.launch_floor_ms(dev),
                      "card": chip_smoke.card_line(), "equal_plain": ok}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

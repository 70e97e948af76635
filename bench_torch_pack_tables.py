"""K8 (pack_tokens) and K9 (block_tables) on one CUDA card, for one tree.

    python3 bench_torch_pack_tables.py [--root DIR] [--reps N]

Imports zippy_tpu_torch and chip_smoke from DIR (default: this checkout),
so that an unpacked `git archive` of a parent commit and this one can be
timed in turns in one run (parent, this, this, parent). The payload is
chip_smoke.py's seeded 64 MiB mixed payload. Prints one JSON line a row,
each with the tree and the card:

- pack_group_L6: the first group of the 64 MiB level-6 encode (55 rows of
  64 KiB blocks, formed by the encoder's _run_buffer and _group_inputs; its
  token cover from find_tokens, its tables from huffman_tables): K8's
  device ms a launch from a CUDA graph of `reps` launches
  (chip_smoke.kernel_ms), the bound that the tree's chip_smoke.pack_work
  gives, the words' dtype, the SHA-256 of the words as uint32 and of the
  bit counts (equal in every tree), and whether K8 equals the tree's plain
  version;
- fetch_group_L6: that group's _encode_group and its fetch (_start_fetch,
  _finish_fetch), and the fetch alone, each profiled once
  (chip_smoke.device_trace): device operations and busy ms;
- tables_batch_64mib: K9 on the first batch of the 64 MiB level-6 raw
  DEFLATE stream's decode (its code-length records as the decode passes
  them, a view into the uploaded packs): device ms a launch (kernel_ms),
  the tree's launch floor, the SHA-256 of the tables, and whether K9
  equals the tree's plain version;
- pack_reads_floor: the loads K8 must make on that group, alone, by a
  probe kernel built here with nvcc (PROBE_SOURCE, into build/bench/; not
  part of the port): the low word of `sym` at every token and of the four
  match fields at every match, one position a thread (neighbouring
  threads at neighbouring positions) and 16 consecutive positions a
  thread (a warp's load then touches 32 lines); and every field's low
  word at every position (the whole arrays). Device ms a launch
  (kernel_ms);
- ptxas: what `nvcc -Xptxas -v` said of pack.cu's and inflate.cu's kernels
  in the tree's build.

Exits non-zero without a CUDA card or when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch


# The probe: K8's loads alone. mode 0: the token and match fields' low
# words at the tokens and matches, a position a thread; mode 1: every
# field's low word at every position; mode 2: as mode 0, 16 consecutive
# positions a thread. The result is folded into one word that is stored
# only if it is a given value, so that no load is dropped.
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t lo(const long long* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}
__global__ void probe(const uint8_t* tok, const uint8_t* mat,
                      const long long* sym, const long long* li,
                      const long long* di, const long long* ln,
                      const long long* ds, long long n, int mode,
                      uint32_t* out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = mode == 2 ? 16 : 1;
  if (t * per >= n) return;
  uint32_t acc = 0;
  for (int j = 0; j < per; ++j) {
    const long long i = t * per + j;
    if (mode == 1 || tok[i]) acc ^= lo(sym + i);
    if (mode == 1 || mat[i])
      acc ^= lo(li + i) ^ lo(di + i) ^ lo(ln + i) ^ lo(ds + i);
  }
  if (acc == 0x12345678u) out[0] = acc;
}
extern "C" int zt_probe(const void* tok, const void* mat, const void* sym,
                        const void* li, const void* di, const void* ln,
                        const void* ds, long long n, int mode, void* out,
                        void* stream) {
  const long long threads = mode == 2 ? (n + 15) / 16 : n;
  probe<<<(unsigned)((threads + 255) / 256), 256, 0,
          (cudaStream_t)stream>>>(
      (const uint8_t*)tok, (const uint8_t*)mat, (const long long*)sym,
      (const long long*)li, (const long long*)di, (const long long*)ln,
      (const long long*)ds, n, mode, (uint32_t*)out);
  return (int)cudaGetLastError();
}
"""


def _probe(kb, root: pathlib.Path):
    """The probe's library, built with the tree's nvcc command."""
    out_dir = root / "build" / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "pack_probe.cu"
    src.write_text(PROBE_SOURCE)
    lib_path = out_dir / "libpack_probe.so"
    subprocess.run(kb._command(src, lib_path), check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    p = ctypes.c_void_p
    lib.zt_probe.argtypes = [p] * 7 + [ctypes.c_longlong, ctypes.c_int, p,
                                       p]
    lib.zt_probe.restype = ctypes.c_int
    return lib


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the tree to import zippy_tpu_torch from")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_pack_tables: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from zippy_tpu_torch.ops import deflate_device as dd
    from zippy_tpu_torch.ops import huffman_kernels as hk
    from zippy_tpu_torch.ops import inflate_device as idev
    from zippy_tpu_torch.ops import inflate_kernels as ik
    from zippy_tpu_torch.ops import kernel_build as kb
    from zippy_tpu_torch.ops import pack_kernels as pk

    dev = torch.device("cuda")
    head = {"tree": str(root), "card": cs.card_line()}
    ok = True

    def emit(row: dict) -> None:
        print(json.dumps({**head, **row}), flush=True)

    libs = kb.build_all(("pack.cu", "inflate.cu"))
    emit({"row": "ptxas", **{name: [
        line.strip() for line in lib.with_suffix(".log").read_text()
        .splitlines() if "entry function" in line or "registers" in line]
        for name, lib in libs.items()}})

    data = cs.mixed_text(cs.MAIN_BYTES, cs.SEED)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())

    # K8 on the first level-6 group, as the encoder forms it.
    k, lazy, min3 = dd._level_params(6)
    g = dd._group_size(k, dd.BLOCK)
    buf = dd._run_buffer(x, 0, g, dd.BLOCK, dd.HIST, dev)
    blocks, lens, hls = dd._group_inputs(buf, 0, 0, g, x.numel(), dd.BLOCK,
                                         dd.HIST)
    params = {"k": k, "lazy": lazy, "hist": dd.HIST, "min3": min3}
    tok = dd.find_tokens(blocks, lens, hls, **params)
    tab = hk.huffman_tables(tok["ll_hist"], tok["dist_hist"], lens.long())
    tables = [tab[key] for key in ("use_ll", "ll_codes", "use_d", "d_codes")]
    words, bits = pk.pack_tokens(tok, *tables)
    want_words, want_bits = pk.pack_tokens_plain(tok, *tables)
    u32 = (words.long() & 0xFFFFFFFF).to(torch.int64)
    equal = bool(torch.equal(u32, want_words.long() & 0xFFFFFFFF)
                 and torch.equal(bits, want_bits))
    ok &= equal
    n_block = tok["is_tok"].shape[1]
    bound_ms, bound_by = cs.bound(cs.pack_work(g, n_block, tok))
    ms = cs.kernel_ms(lambda: pk.pack_tokens(tok, *tables), args.reps)
    emit({"row": "pack_group_L6", "rows": g, "ms": ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "bound_share": bound_ms / ms,
          "words_dtype": str(words.dtype).replace("torch.", ""),
          "words_u32_sha256": hashlib.sha256(u32.cpu().numpy().astype(
              "<u4").tobytes()).hexdigest(),
          "total_bits_sha256": _sha(bits), "equal_plain": equal,
          "tokens": int(tok["is_tok"].sum()),
          "matches": int(tok["is_match"].sum())})

    # The loads alone, by the probe.
    probe = _probe(kb, root)
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    ptrs = [tok[key].data_ptr() for key in ("is_tok", "is_match", "sym",
                                             "len_idx", "dist_idx",
                                             "length", "dist")]
    floors = {}
    for name, mode in (("coalesced_ms", 0), ("sixteen_a_thread_ms", 2),
                       ("whole_arrays_ms", 1)):
        def launch(mode=mode):
            rc = probe.zt_probe(*ptrs, tok["is_tok"].numel(), mode,
                                sink.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"probe launch failed: {rc}")
        floors[name] = cs.kernel_ms(launch, args.reps)
    emit({"row": "pack_reads_floor", "rows": g, **floors})

    # The group's encode and fetch, and the fetch alone, profiled.
    res = dd._encode_group(blocks, lens, hls, **params)
    torch.cuda.synchronize()
    whole = cs.device_trace(lambda: dd._finish_fetch(dd._start_fetch(
        dd._encode_group(blocks, lens, hls, **params))))
    fetch = cs.device_trace(lambda: dd._finish_fetch(dd._start_fetch(res)))
    emit({"row": "fetch_group_L6", "rows": g,
          "group_and_fetch": {key: whole[key] for key in (
              "device_ops", "device_busy_s", "top_device_ms", "tries")},
          "fetch": {key: fetch[key] for key in (
              "device_ops", "device_busy_s", "top_device_ms", "tries")}})
    del tok, tab, tables, words, want_words, res, buf, blocks

    # K9 on the first batch of the 64 MiB level-6 stream's decode.
    body = dd.deflate(data, 6)
    index = idev.build_decode_index(body)
    cfg = idev._pick_cfg(index["total_out"])
    batch = cs._batches(idev, idev._plan_tiles(index, cfg))[0]
    keep: list = []
    packs = idev._upload_packs(
        [idev._tile_pack(body, index, t, cfg,
                         idev._nrounds_for_depth(t.depth, cfg))
         for t in batch], dev, keep)
    lens8 = idev._unpack(packs, cfg)[4]
    rows = lens8.shape[0] * lens8.shape[1]
    got = ik.block_tables(lens8)
    equal = bool(torch.equal(got, ik.block_tables_plain(
        lens8.reshape(-1, 318))))
    ok &= equal
    ms = cs.kernel_ms(lambda: ik.block_tables(lens8), args.reps)
    floor_ms = cs.launch_floor_ms(dev)
    bound_ms, bound_by = cs.bound(cs.tables_work(rows))
    emit({"row": "tables_batch_64mib", "tiles": len(batch), "rows": rows,
          "ms": ms, "launch_floor_ms": floor_ms,
          "floor_multiple": ms / floor_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "tables_sha256": _sha(got),
          "body_sha256": hashlib.sha256(body).hexdigest(),
          "equal_plain": equal})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

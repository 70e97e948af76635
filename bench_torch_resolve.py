"""The decode's LZ resolution on one CUDA card, for one tree.

    python3 bench_torch_resolve.py [--root DIR] [--reps N]

Imports zippy_tpu_torch, chip_smoke and bench_torch_device from DIR
(default: this checkout), so that an unpacked `git archive` of a parent
commit and this one can be timed in turns in one run (parent, this, this,
parent). The payload is chip_smoke.py's seeded 64 MiB mixed payload. Prints
one JSON line a row, each with the tree and the card:

- resolve_tile: the tree's `inflate_device._resolve` on the first tile of
  the port's 64 MiB gzip L6 stream (CFG_L), of the first 1 MiB member
  of compress_device_indexed at 1 MiB members (CFG_S) and of a zip
  entry (chip_smoke.archive_tree's text entry nearest its 16 KiB median,
  deflated at level 1, as create_zip_archive does), inputs as the
  decode forms them: ms a call from CUDA events (the host's issue counts),
  and from a profile of 20 calls the card's busy ms, operations and idle
  share a call; where the tree has ops/resolve_kernels (kernel K6), its
  launches against nrounds + 3, its device ms from a CUDA graph, the
  plain version's ms, and whether the two agree on out[:HALO + used];
- decode_given_index_64mib: inflate_device_array of that stream given its
  index, `reps` times (seconds), one run's synchronized stages, and a
  profile (device operations, busy seconds, idle share, top kernels);
- extract_all_zip: chip_smoke.archive_tree's 1,032 files zipped by
  create_zip_archive, extracted `reps` times (seconds, the tree checked),
  and a profile of the extract of its first 128 files;
- bench_torch_device.py's decode rows (decode_scan_*,
  device_inflate_tile_*, device_inflate_e2e_resident_*) for its three
  streams.

The decode rows repeat measurements that chip_smoke.py and
bench_torch_device.py make; this script is kept because it makes them the
same way in a tree with kernel K6 and in one without it (whose `_resolve`
takes the host span lists), which is how PERF.md's resolve, decode given
its index and extract_all_zip numbers are held against the parent's.

Exits non-zero without a CUDA card or when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import time
import zlib

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the tree to import zippy_tpu_torch from")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_resolve: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import bench_torch_device as btd
    import chip_smoke as cs
    import zippy_tpu_torch as zt
    from zippy_tpu_torch import api
    from zippy_tpu_torch import gzip_format as gf
    from zippy_tpu_torch.ops import deflate_device as dd
    from zippy_tpu_torch.ops import inflate_device as idev
    from zippy_tpu_torch.ops import inflate_kernels as ik
    from zippy_tpu_torch.ops import kernel_build as kb

    try:
        from zippy_tpu_torch.ops import resolve_kernels as rk
    except ImportError:
        rk = None
    dev = torch.device("cuda")
    head = {"tree": str(root), "card": cs.card_line()}

    def emit(row: str, **fields) -> None:
        print(json.dumps({"row": row, **head, **fields}), flush=True)

    kb.build_all()
    data = cs.mixed_text(cs.MAIN_BYTES, cs.SEED)
    gz6 = api.compress(data, 6)
    index = idev.build_decode_index(gz6, gf.parse_header(gz6)[
        "data_offset"] * 8)
    member = gf.compress_device_indexed(data[:1 << 20], 6,
                                        member_size=1 << 20)
    body = member[gf.parse_header(member)["data_offset"]:]
    entry = min((v for i, v in enumerate(cs.archive_tree(data).values())
                 if i % 16 != 15 and v),
                key=lambda v: abs(len(v) - cs.ARCHIVE_MEDIAN))
    small = dd.deflate(entry, 1)

    for label, blob, idx, want in (
            ("gzip L6 64 MiB, first tile", gz6, index, data),
            ("1 MiB member, first tile", body, idev.build_decode_index(body),
             data[:1 << 20]),
            ("zip entry", small, idev.build_decode_index(small), entry)):
        cfg = idev._pick_cfg(idx["total_out"])
        tile = idev._plan_tiles(idx, cfg)[0]
        nrounds = idev._nrounds_for_depth(tile.depth, cfg)
        keep: list = []
        packs = idev._upload_packs(
            [idev._tile_pack(blob, idx, tile, cfg, nrounds)], dev, keep)
        words, seg, seg_out, *sto, lens8 = idev._unpack(packs, cfg)
        lanes, k = tile.s1 - tile.s0, int(idx["every"])
        packed = ik.inflate_extract(words, seg, [lanes], idev._block_tables(
            lens8.reshape(-1, 318)), k)
        halo = torch.zeros(idev.HALO, dtype=torch.uint8, device=dev)
        if rk is None:  # the tree before K6: the spans as host ints
            call = (packed, seg_out[0, :lanes], words[0],
                    idev._tile_stored(idx, tile), halo, nrounds, cfg)
        else:
            call = (packed, seg_out[0, :lanes], words[0], sto[0][0], halo,
                    tile.used, nrounds, cfg)
        out = idev._resolve(*call)
        ok = (out[idev.HALO:idev.HALO + tile.used].cpu().numpy().tobytes()
              == want[:tile.used])
        cs.check(ok, label)
        fields = {"tile_bytes": cfg.tile_out, "used": tile.used,
                  "busy_lanes": lanes, "nrounds": nrounds,
                  "call_ms": cs.call_ms(lambda: idev._resolve(*call), 20)}
        tr = cs.device_trace(lambda: [idev._resolve(*call)
                                      for _ in range(20)])
        if tr["device_busy_s"] is not None:
            fields.update(busy_ms=tr["device_busy_s"] / 20 * 1e3,
                          device_ops=tr["device_ops"] / 20,
                          device_idle_share=tr["device_idle_share"])
        if rk is not None:
            n = rk.HALO + tile.used
            pargs = (packed, seg_out[0, :lanes], words[0],
                     rk.stored_spans(sto[0][0]), halo, nrounds, cfg)
            plain = rk._resolve_plain(*pargs)
            try:  # a tree whose K6 picks its regime by the tile's bytes
                k6_launches = rk.launches_per_tile(nrounds, tile.used)
            except TypeError:
                k6_launches = rk.launches_per_tile(nrounds)
            fields.update(
                k6_launches=k6_launches,
                launch_budget=nrounds + 3,
                k6_ms=cs.kernel_ms(lambda: rk.lz_resolve(*call), 20),
                plain_ms=cs.call_ms(lambda: rk._resolve_plain(*pargs), 2),
                k6_equal_plain=bool(torch.equal(rk.lz_resolve(*call)[:n],
                                                plain[:n])))
            cs.check(fields["k6_equal_plain"], label + ": K6 against plain")
        emit("resolve_tile", run=label, **fields)
        del keep, packs, packed, out

    seconds = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf, total = idev.inflate_device_array(gz6, index)
        seconds.append(time.perf_counter() - t0)
        cs.check(buf.cpu().numpy().tobytes() == data, "decode given index")
        del buf
    stages: dict = {}
    idev.inflate_device_array(gz6, index, stages=stages)
    emit("decode_given_index_64mib", seconds=seconds,
         tiles=len(idev._plan_tiles(index, idev._pick_cfg(total))),
         stages_s=stages,
         trace=cs.device_trace(lambda: idev.inflate_device_array(gz6,
                                                                 index)))
    torch.cuda.empty_cache()

    work = root / "build" / "bench_resolve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    tree = cs.archive_tree(data)
    zpath = work / "tree.zip"
    zpath.write_bytes(zt.create_zip_archive(tree))
    seconds = []
    for _ in range(args.reps):
        dest = work / "out"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zt.extract_all_zip(zpath, dest)
        seconds.append(time.perf_counter() - t0)
        cs.check(cs._read_tree(dest) == tree, "extract_all_zip")
        shutil.rmtree(dest)
    part = dict(list(tree.items())[:cs.TRACE_FILES])
    part_zip = work / "part.zip"
    part_zip.write_bytes(zt.create_zip_archive(part))
    emit("extract_all_zip", files=len(tree),
         bytes=sum(map(len, tree.values())), seconds=seconds,
         trace_files=len(part),
         trace=cs.device_trace(lambda: zt.extract_all_zip(
             part_zip, work / "part_out")))
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    bench = btd.Bench()
    bench.rec = lambda r: emit(r["name"], **r)
    for label, n in btd.LABELS.items():
        src = data[:n]
        blob = (dd.deflate(src, 6) if label == "mixed64mib"
                else zlib.compress(src, 6)[2:-4])
        bench.decode(label, blob, src)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

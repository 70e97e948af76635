"""Device benchmark of zippy_tpu_torch on one CUDA card: the port's
counterpart of bench_device.py, row by row.

    python3 bench_torch_device.py [--out PATH] [--root DIR] [--groups G,...]

Rows, in the order they run (each printed as one JSON line), by group
(--groups; the default runs all but `compress`):

start:

- launch_latency (ms): one tiny kernel's launch and torch.cuda.synchronize,
  host clock;
- kernel_build (s): ops/kernel_build.build_all(), taken first so that nvcc
  is not counted in the warmup; `built` lists the libraries it had to build
  (none when an earlier command of the same run built them);
- warmup_wall (s): zippy_tpu_torch.warmup(), its first call in the process;
- warm_first_uncompress_device, warm_first_compress_device,
  warm_second_compress_device (s): uncompress() of a zlib L6 stream of the
  1 MiB payload, then compress(src, 1, dfDeflate) twice, right after warmup;
transfers, checksums, decode, indexed:
- h2d_pinned, h2d_pageable (64 MiB) and d2h_pinned (8 MiB) (GB/s), against
  the PCIe link nvidia-smi reports;
- device_crc32, device_adler32 (GB/s): checksums.crc32_tensor and
  adler32_tensor of a resident 64 MiB tensor; roofline_frac is the rate
  while the card is busy (device_ms_per_call, from a profile) against
  3.35 TB/s;
- decode_scan_{label} (GB/s of output): inflate_device.build_decode_index;
- device_inflate_tile_{label} (GB/s): the first tile decoded from its
  pre-uploaded pack (_tile_pack, _upload_packs, _decode_tile), with the
  reference's roofline model of (24 + 8 nrounds) bytes of device memory
  traffic per output byte, against 3.35 TB/s (roofline_frac: of the busy
  rate, as for the checksums);
- device_inflate_e2e_resident_{label} (GB/s): inflate_device_array of the
  stream given its index, into a tensor on the card;
  for the labels mixed1mib and mixed16mib (CPython's zlib L6 of the 1 and
  16 MiB payloads) and mixed64mib (the port's own L6 stream of 64 MiB:
  1,024 blocks, so its scan runs the second pass ROADMAP.md §C describes);
- device_inflate_indexed_e2e_resident_16mib (GB/s):
  compress_device_indexed of the 16 MiB payload at 8 MiB members, decoded
  by uncompress_device(array=True), with the index's share of the stream
  against compress_indexed's;
encode:
- device_encode_group_L{1,6} (GB/s of input): one _encode_group of the
  level's group size of 64 KiB blocks with HIST history, with ms per
  dispatch and the synchronized split of its stages (find_tokens; the Kraft
  build with the header cost and codes; pack);
- device_encode_stage_find_L{1,6} (ms): find_tokens alone on the same rows.
compress (the encoder's stages and the calls around them):
- stream_digests (s): deflate_device.deflate of the payload's first 8 MiB
  at levels -2, -1, 1, 6 and 9 and of 64 MiB at level 6, with the SHA-256
  of each stream (two trees' digests equal: the same bytes); and
  `api_digests`, the SHA-256 of the raw bodies of chip_smoke.py phase 4's
  four compress() streams (chip_smoke.phase4_digests);
- find_group_L{6,1} (ms): find_tokens on the first group of the level's
  encode of the 64 MiB payload (55 rows at level 6, 64 at level 1), 10
  calls a sample; from a profile of 10 calls the card's busy ms,
  operations and idle share a call; where the tree has ops/match_kernels
  (kernel K7), K7's own device ms (and by kernel) and the rest's (a
  library sort in older trees) apart, its
  launches a group, its plain version's ms and the bound
  (chip_smoke.find_work);
- compress_64mib_l6_tensor (s): deflate_array of the payload on the card
  at level 6, with one run's synchronized stages, a profile and the peak
  device memory;
- compress_peak_memory_64mib_l6, compress_peak_memory_8mib_l9 (s):
  api.compress of the payload (gzip) and of its first 8 MiB (zlib) from
  host bytes, with the peak device memory;
- create_zip_archive (s): chip_smoke.archive_tree's 1,032 files zipped,
  the archive read back by zipfile.

--root imports zippy_tpu_torch from another tree (an unpacked `git
archive` of a parent commit), so that two trees are timed in turns in one
chip call: `--groups encode,compress`, parent, this, this, parent.

The payload is chip_smoke.py's mixed text, from its SEED. Every decode is checked
against its payload and every encode is decoded by CPython's zlib; a failed
check exits non-zero and writes nothing. So does a host without a CUDA card.
The artifact (--out, default chiprun_out/bench_torch_device.json) holds the
card's name and power limit, the torch and CUDA versions, the date, the
method and the rows.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import pathlib
import statistics
import subprocess
import sys
import time
import zipfile
import zlib

import numpy as np
import torch

from chip_smoke import (HBM_BYTES_PER_S, MAIN_BYTES, SEED, ZLIB_BYTES,
                        archive_tree, bound, card_line, check, device_trace,
                        find_work, mixed_text, phase4_digests)

OUT = pathlib.Path("chiprun_out") / "bench_torch_device.json"
HBM_GBPS = HBM_BYTES_PER_S / 1e9
REPS = 5          # samples a row, after one warm-up call
CALLS = 20        # back-to-back calls inside one sample of a kernel row
LABELS = {"mixed1mib": 1 << 20, "mixed16mib": 16 << 20,
          "mixed64mib": 64 << 20}
LEVELS = (1, 6)
GROUPS = ("start", "transfers", "checksums", "decode", "indexed", "encode",
          "compress")
DEFAULT_GROUPS = GROUPS[:-1]
FIND_CALLS = 10   # find_tokens calls a sample of a find_group row
INDEXED_BYTES = 16 << 20
INDEXED_MEMBER = 8 << 20
H2D_BYTES = 64 << 20
D2H_BYTES = 8 << 20
# Usable Gbit/s of one PCIe lane, one direction, by generation: 8b/10b
# coding up to gen 2, 128b/130b from gen 3.
PCIE_LANE_GBIT = {1: 2.0, 2: 4.0, 3: 8 * 128 / 130, 4: 16 * 128 / 130,
                  5: 32 * 128 / 130}

METHOD = {
    "samples": f"the median, min and max of {REPS} samples after one "
               "warm-up call; first-call rows (kernel_build, warmup_wall, "
               "warm_*) are one sample",
    "kernel_rows": f"CUDA events around {CALLS} back-to-back calls a sample "
                   "(launch_latency: the host clock around each launch and "
                   "synchronize); the host's issue of each call counts",
    "device_time": f"device_crc32, device_adler32, device_inflate_tile_*: "
                   f"one torch.profiler trace of {CALLS} calls gives the "
                   "card's busy ms a call (its operations' summed time) and "
                   "its idle share of the traced wall time; roofline_frac "
                   "is the rate while busy against the roofline",
    "group_rows": "CUDA events around one call a sample "
                  "(device_encode_*: thousands of launches a call)",
    "end_to_end_rows": "host clock around the call, ending in "
                       "torch.cuda.synchronize() (decode_scan_*: host work)",
    "runs": "one run; runs on a dedicated card are compared, not merged",
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", type=pathlib.Path, default=OUT,
                   help="where the artifact is written (JSON)")
    p.add_argument("--root", type=pathlib.Path,
                   default=pathlib.Path(__file__).resolve().parent,
                   help="the tree to import zippy_tpu_torch from")
    p.add_argument("--groups", type=lambda v: tuple(v.split(",")),
                   default=DEFAULT_GROUPS,
                   help=f"the groups of rows to run, of {','.join(GROUPS)}")
    args = p.parse_args(argv)
    bad = set(args.groups) - set(GROUPS)
    if bad:
        p.error(f"unknown groups {sorted(bad)}")
    return args


def row_names(groups=DEFAULT_GROUPS) -> list[str]:
    """Every row the artifact of `groups` holds, in the order they run."""
    names = []
    if "start" in groups:
        names += ["launch_latency", "kernel_build", "warmup_wall",
                  "warm_first_uncompress_device",
                  "warm_first_compress_device", "warm_second_compress_device"]
    if "transfers" in groups:
        names += ["h2d_pinned", "h2d_pageable", "d2h_pinned"]
    if "checksums" in groups:
        names += ["device_crc32", "device_adler32"]
    if "decode" in groups:
        for label in LABELS:
            names += [f"decode_scan_{label}", f"device_inflate_tile_{label}",
                      f"device_inflate_e2e_resident_{label}"]
    if "indexed" in groups:
        names.append("device_inflate_indexed_e2e_resident_16mib")
    if "encode" in groups:
        for level in LEVELS:
            names += [f"device_encode_group_L{level}",
                      f"device_encode_stage_find_L{level}"]
    if "compress" in groups:
        names += ["stream_digests", "find_group_L6", "find_group_L1",
                  "compress_64mib_l6_tensor", "compress_peak_memory_64mib_l6",
                  "compress_peak_memory_8mib_l9", "create_zip_archive"]
    return names


def pcie_gbps(gen: int, width: int) -> float:
    """GB/s one direction of a PCIe link of `width` lanes of generation
    `gen`, after line coding (packet headers not counted)."""
    return PCIE_LANE_GBIT[gen] * width / 8


def tile_roofline_gbps(nrounds: int) -> float:
    """Output GB/s of a decode tile under the reference's model: per output
    byte the resolve moves about three int32 arrays (24 bytes with their
    scatters) and 8 bytes a pointer-doubling round."""
    return HBM_GBPS / (24 + 8 * nrounds)


def summary(samples: list) -> dict:
    return {"median": statistics.median(samples), "min": min(samples),
            "max": max(samples), "samples": len(samples)}


def row(name: str, unit: str, samples: list, **extra) -> dict:
    """One artifact row: the median, min and max of `samples`, in `unit`."""
    return {"name": name, "unit": unit, **summary(samples), **extra}


def artifact(card: str, device_name: str, rows: list,
             groups=DEFAULT_GROUPS, root: str | None = None) -> dict:
    """The artifact: the card (nvidia-smi's name and power limit), the
    versions, the date, the method, the tree timed (`root`, where not this
    one) and the rows, which must be exactly row_names(groups)."""
    names = [r["name"] for r in rows]
    if sorted(names) != sorted(row_names(groups)):
        raise ValueError(f"rows {names} are not {row_names(groups)}")
    name, _, power = card.partition(",")
    return {"card": {"nvidia_smi": card, "name": name.strip(),
                     "power_limit": power.strip(),
                     "torch_name": device_name},
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "date": time.strftime("%Y-%m-%d"), "seed": SEED,
            "method": METHOD, "groups": list(groups), "root": root,
            "rows": rows}


def pcie_link() -> dict | None:
    """Card 0's PCIe link (generation and width) as nvidia-smi reports it,
    or None where it reports none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=pcie.link.gen.current,"
             "pcie.link.width.current", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        gen, width = (int(v) for v in out.split(","))
    except (OSError, subprocess.SubprocessError, ValueError):
        return None
    return {"gen": gen, "width": width}


def events_s(fn, calls: int) -> float:
    """Seconds per call of fn() from CUDA events around `calls` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls / 1e3


def device_samples(fn, calls: int = CALLS) -> list[float]:
    """REPS samples of events_s after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    return [events_s(fn, calls) for _ in range(REPS)]


def host_s(fn) -> float:
    """Host seconds of fn(), ending in torch.cuda.synchronize()."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def host_samples(fn) -> list[float]:
    """REPS samples of host_s after one warm-up call."""
    host_s(fn)
    return [host_s(fn) for _ in range(REPS)]


def gbps(nbytes: int, seconds: list) -> list[float]:
    return [nbytes / s / 1e9 for s in seconds]


def busy_fields(fn, nbytes: int, roof_gbps: float) -> dict:
    """fn() CALLS times under one device_trace: the card's busy ms a call,
    its idle share of the traced wall time, its operations a call, and
    roofline_frac, the rate while busy against roof_gbps (None where the
    profile saw no device work)."""
    tr = device_trace(lambda: [fn() for _ in range(CALLS)])
    busy = tr["device_busy_s"]
    if busy is None:
        return {"device_ms_per_call": None, "device_idle_share": None,
                "device_ops_per_call": None, "roofline_frac": None,
                "trace_tries": tr["tries"]}
    return {"device_ms_per_call": busy / CALLS * 1e3,
            "device_idle_share": tr["device_idle_share"],
            "device_ops_per_call": tr["device_ops"] / CALLS,
            "roofline_frac": nbytes * CALLS / busy / 1e9 / roof_gbps,
            "trace_tries": tr["tries"]}


class Bench:
    """The rows of one run on card 0, printed as they are taken."""

    def __init__(self):
        self.dev = torch.device("cuda", 0)
        self.rows: list = []

    def rec(self, r: dict) -> dict:
        self.rows.append(r)
        print(json.dumps(r), flush=True)
        return r

    def start(self, data: bytes) -> None:
        """launch_latency, kernel_build, warmup_wall and the warm rows."""
        import zippy_tpu_torch as zt
        from zippy_tpu_torch.ops import kernel_build as kb

        tiny = torch.zeros(8, dtype=torch.int32, device=self.dev)

        def tick():
            tiny.add_(1)
            torch.cuda.synchronize()

        tick()
        lat = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                tick()
            lat.append((time.perf_counter() - t0) / CALLS * 1e3)
        self.rec(row("launch_latency", "ms", lat))

        names = kb.CUDA_SOURCES + kb.HOST_SOURCES
        missing = [n for n in names if not kb.library_path(n).exists()]
        t0 = time.perf_counter()
        kb.build_all()
        self.rec(row("kernel_build", "s", [time.perf_counter() - t0],
                     built=missing))

        t0 = time.perf_counter()
        calls = zt.warmup()
        torch.cuda.synchronize()
        self.rec(row("warmup_wall", "s", [time.perf_counter() - t0],
                     calls=calls))

        src = data[:LABELS["mixed1mib"]]
        blob = zlib.compress(src, 6)
        t0 = time.perf_counter()
        out = zt.uncompress(blob)
        self.rec(row("warm_first_uncompress_device", "s",
                     [time.perf_counter() - t0], bytes=len(src)))
        check(out == src, "warm uncompress")
        for name in ("warm_first_compress_device",
                     "warm_second_compress_device"):
            t0 = time.perf_counter()
            out = zt.compress(src, 1, zt.dfDeflate)
            self.rec(row(name, "s", [time.perf_counter() - t0],
                         bytes=len(src)))
            check(zlib.decompress(out, -15) == src, name)

    def transfers(self) -> None:
        """h2d_pinned, h2d_pageable, d2h_pinned against the PCIe link."""
        dst = torch.empty(H2D_BYTES, dtype=torch.uint8, device=self.dev)
        pinned = torch.ones(H2D_BYTES, dtype=torch.uint8).pin_memory()
        pageable = torch.ones(H2D_BYTES, dtype=torch.uint8)
        src = torch.ones(D2H_BYTES, dtype=torch.uint8, device=self.dev)
        back = torch.empty(D2H_BYTES, dtype=torch.uint8).pin_memory()
        runs = []
        for name, nbytes, fn in (
                ("h2d_pinned", H2D_BYTES,
                 lambda: dst.copy_(pinned, non_blocking=True)),
                ("h2d_pageable", H2D_BYTES, lambda: dst.copy_(pageable)),
                ("d2h_pinned", D2H_BYTES,
                 lambda: back.copy_(src, non_blocking=True))):
            runs.append((name, nbytes, gbps(nbytes, device_samples(fn))))
        check(bool((back == 1).all()), "device to host copy")
        link = pcie_link()
        roof = None if link is None else pcie_gbps(link["gen"],
                                                   link["width"])
        for name, nbytes, rates in runs:
            r = row(name, "GB/s", rates, bytes=nbytes, pcie_link=link,
                    pcie_gbps=roof)
            r["roofline_frac"] = None if roof is None else r["median"] / roof
            self.rec(r)

    def checksums(self) -> None:
        """device_crc32 and device_adler32 of a resident 64 MiB tensor."""
        from zippy_tpu_torch.ops import checksums as cks

        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED)
        n = 64 << 20
        buf = torch.randint(0, 256, (n,), dtype=torch.uint8, device=self.dev,
                            generator=gen)
        host = buf.cpu().numpy().tobytes()
        check(int(cks.crc32_tensor(buf)) == zlib.crc32(host), "crc32")
        check(int(cks.adler32_tensor(buf)) == zlib.adler32(host), "adler32")
        for name, fn in (("device_crc32", lambda: cks.crc32_tensor(buf)),
                         ("device_adler32", lambda: cks.adler32_tensor(buf))):
            secs = device_samples(fn)
            self.rec(row(name, "GB/s", gbps(n, secs), bytes=n,
                         ms_per_call=statistics.median(secs) * 1e3,
                         roofline_gbps=HBM_GBPS,
                         **busy_fields(fn, n, HBM_GBPS)))

    def decode(self, label: str, blob: bytes, src: bytes) -> None:
        """decode_scan, device_inflate_tile, device_inflate_e2e_resident of
        one raw DEFLATE stream."""
        from zippy_tpu_torch.ops import inflate_device as idev

        index = idev.build_decode_index(blob)
        total = int(index["total_out"])
        check(total == len(src), f"{label}: scanned size")
        # The scan's first call has room for 256 Huffman blocks and 256
        # stored spans; a stream with more is scanned a second time.
        self.rec(row(f"decode_scan_{label}", "GB/s", gbps(total, host_samples(
            lambda: idev.build_decode_index(blob))),
            huffman_blocks=len(index["block_lens"]),
            stored_spans=len(index["stored"])))

        cfg = idev._pick_cfg(total)
        tiles = idev._plan_tiles(index, cfg)
        tile = tiles[0]
        nrounds = idev._nrounds_for_depth(tile.depth, cfg)
        keep: list = []
        packs = idev._upload_packs(
            [idev._tile_pack(blob, index, tile, cfg, nrounds)], self.dev, keep)
        halo = torch.zeros(idev.HALO, dtype=torch.uint8, device=self.dev)

        def one_tile():
            return idev._decode_tile(packs[0], halo, tile,
                                     k=int(index["every"]), cfg=cfg)

        out = one_tile()[idev.HALO:idev.HALO + tile.used]
        check(out.cpu().numpy().tobytes() == src[:tile.used],
              f"{label}: first tile")
        secs = device_samples(one_tile)
        roof = tile_roofline_gbps(nrounds)
        self.rec(row(f"device_inflate_tile_{label}", "GB/s",
                     gbps(tile.used, secs), tile_bytes=tile.used,
                     nrounds=nrounds,
                     ms_per_tile=statistics.median(secs) * 1e3,
                     roofline_gbps=roof,
                     **busy_fields(one_tile, tile.used, roof)))
        del keep

        buf, got = idev.inflate_device_array(blob, index)
        check(got == total and buf.cpu().numpy().tobytes() == src,
              f"{label}: resident decode")
        del buf
        self.rec(row(f"device_inflate_e2e_resident_{label}", "GB/s",
                     gbps(total, host_samples(
                         lambda: idev.inflate_device_array(blob, index))),
                     tiles=len(tiles)))

    def indexed(self, src: bytes) -> None:
        """device_inflate_indexed_e2e_resident_16mib."""
        from zippy_tpu_torch import gzip_format as gf

        iblob = gf.compress_device_indexed(src, 6,
                                           member_size=INDEXED_MEMBER)
        plain = gf.compress_indexed(src, 6, member_size=INDEXED_MEMBER)
        parts = gf.uncompress_device(iblob, array=True)
        check(b"".join(a.cpu().numpy().tobytes() for a, _ in parts) == src,
              "indexed decode")
        del parts
        self.rec(row("device_inflate_indexed_e2e_resident_16mib", "GB/s",
                     gbps(len(src), host_samples(
                         lambda: gf.uncompress_device(iblob, array=True))),
                     members=len(src) // INDEXED_MEMBER,
                     index_overhead_pct=100 * (len(iblob) - len(plain))
                     / len(plain)))

    def encode(self, level: int, data: bytes) -> None:
        """device_encode_group and device_encode_stage_find at `level`."""
        from zippy_tpu_torch.ops import deflate_device as dd

        k, lazy, min3 = dd._level_params(level)
        g = dd._group_size(k, dd.BLOCK)
        src = data[:g * dd.BLOCK]
        hist = dd.HIST
        # The first group of the encoder's own run over the g blocks.
        x = torch.from_numpy(np.frombuffer(src, np.uint8).copy())
        buf = dd._run_buffer(x, 0, g, dd.BLOCK, hist, self.dev)
        blocks, lens, hls = dd._group_inputs(buf, 0, 0, g, len(src),
                                             dd.BLOCK, hist)
        params = {"k": k, "lazy": lazy, "hist": hist, "min3": min3}

        res = dd._encode_group(blocks, lens, hls, **params)
        meta, words = dd._finish_fetch(dd._start_fetch(res))
        out = dd._ByteBitAppender()
        raw = np.frombuffer(src, np.uint8)
        dd._splice_group(meta, words, [(out, dd.BLOCK, j == g - 1)
                                       for j in range(g)],
                         lambda j: raw[j * dd.BLOCK:(j + 1) * dd.BLOCK])
        check(zlib.decompress(bytes(out.out), -15) == src,
              f"L{level}: encode group")
        del res

        secs = device_samples(
            lambda: dd._encode_group(blocks, lens, hls, **params), 1)
        splits = []
        for _ in range(REPS):
            stages: dict = {}
            dd._encode_group(blocks, lens, hls, **params, stages=stages)
            splits.append(stages)
        group_ms = statistics.median(secs) * 1e3
        self.rec(row(f"device_encode_group_L{level}", "GB/s",
                     gbps(len(src), secs), blocks=g,
                     block_kib=dd.BLOCK // 1024, ms_per_dispatch=group_ms,
                     stages_ms={name: summary([s[name] * 1e3
                                               for s in splits])
                                for name in splits[0]}))
        find = device_samples(lambda: dd.find_tokens(
            blocks, lens, hls, k=k, lazy=lazy, hist=hist, min3=min3), 1)
        self.rec(row(f"device_encode_stage_find_L{level}", "ms",
                     [s * 1e3 for s in find], of_total_ms=group_ms))

    def compress(self, data: bytes) -> None:
        """The compress group: stream_digests, find_group_L{6,1},
        compress_64mib_l6_tensor, compress_peak_memory_*,
        create_zip_archive."""
        import zippy_tpu_torch as zt
        from zippy_tpu_torch import api, common
        from zippy_tpu_torch.ops import deflate_device as dd

        try:
            from zippy_tpu_torch.ops import match_kernels as mk
        except ImportError:   # a tree from before K7
            mk = None
        digests, t0 = {}, time.perf_counter()
        for level, n in ((-2, ZLIB_BYTES), (-1, ZLIB_BYTES), (1, ZLIB_BYTES),
                         (6, ZLIB_BYTES), (9, ZLIB_BYTES), (6, MAIN_BYTES)):
            digests[f"L{level} {n >> 20} MiB"] = hashlib.sha256(
                dd.deflate(data[:n], level)).hexdigest()
        # And the raw bodies of chip_smoke.py phase 4's streams, written
        # through compress() as phase 4 writes them.
        small = data[:ZLIB_BYTES]
        x_dev = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(
            self.dev)
        api_digests = phase4_digests({
            "gzip L6 host bytes": api.compress(data, 6, common.dfGzip),
            "gzip L6 cuda tensor": api.compress(x_dev, 6, common.dfGzip),
            "zlib L1 host bytes": api.compress(small, 1, common.dfZlib),
            "zlib L9 host bytes": api.compress(small, 9, common.dfZlib)})
        del x_dev
        self.rec(row("stream_digests", "s", [time.perf_counter() - t0],
                     digests=digests, api_digests=api_digests))

        x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
        for level in (6, 1):
            self.rec(self._find_group(dd, mk, x, level))
            torch.cuda.empty_cache()

        x_dev = x.to(self.dev)
        body = dd.deflate(data, 6)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs = []
        secs = host_samples(lambda: outs.append(dd.deflate_array(x_dev, 6)))
        check(all(out == body for out in outs), "deflate_array equals deflate")
        peak = torch.cuda.max_memory_allocated() / 2**30
        stages: dict = {}
        dd.deflate_array(x_dev, 6, stages=stages)
        self.rec(row("compress_64mib_l6_tensor", "s", secs, bytes=len(data),
                     stages_s=stages, peak_device_GiB=peak,
                     trace=device_trace(lambda: dd.deflate_array(x_dev, 6))))
        del x_dev, outs
        torch.cuda.empty_cache()

        for name, src, level, fmt in (
                ("compress_peak_memory_64mib_l6", data, 6, common.dfGzip),
                ("compress_peak_memory_8mib_l9", data[:ZLIB_BYTES], 9,
                 common.dfZlib)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            blobs = []
            secs = host_samples(lambda: blobs.append(api.compress(
                src, level, fmt)))
            back = (zlib.decompress(blobs[-1], 31) if fmt is common.dfGzip
                    else zlib.decompress(blobs[-1]))
            check(back == src, name)
            self.rec(row(name, "s", secs, bytes=len(src),
                         compressed_bytes=len(blobs[-1]),
                         peak_device_GiB=torch.cuda.max_memory_allocated()
                         / 2**30))
            del blobs
            torch.cuda.empty_cache()

        tree = archive_tree(data)
        blobs = []
        secs = host_samples(lambda: blobs.append(zt.create_zip_archive(tree)))
        with zipfile.ZipFile(io.BytesIO(blobs[-1])) as zf:
            check(all(zf.read(name) == contents
                      for name, contents in tree.items()),
                  "create_zip_archive")
        self.rec(row("create_zip_archive", "s", secs, files=len(tree),
                     bytes=sum(map(len, tree.values())),
                     zip_bytes=len(blobs[-1])))

    def _find_group(self, dd, mk, x: torch.Tensor, level: int) -> dict:
        """find_group_L{level}: find_tokens on the first group of the
        level's encode of x."""
        k, lazy, min3 = dd._level_params(level)
        g = dd._group_size(k, dd.BLOCK)
        buf = dd._run_buffer(x, 0, g, dd.BLOCK, dd.HIST, self.dev)
        blocks, lens, hls = dd._group_inputs(buf, 0, 0, g, x.numel(),
                                             dd.BLOCK, dd.HIST)
        params = {"k": k, "lazy": lazy, "hist": dd.HIST, "min3": min3}

        def call():
            return dd.find_tokens(blocks, lens, hls, **params)

        secs = device_samples(call, FIND_CALLS)
        fields = {"rows": g, "k": k}
        trace = device_trace(lambda: [call() for _ in range(FIND_CALLS)],
                             match=None if mk is None else "k7_")
        busy = trace["device_busy_s"]
        if busy is not None:
            fields.update(busy_ms=busy / FIND_CALLS * 1e3,
                          device_ops=trace["device_ops"] / FIND_CALLS,
                          device_idle_share=trace["device_idle_share"])
        if mk is not None:
            bound_ms, bound_by = bound(find_work(
                g, dd.BLOCK, blocks.shape[1], k, min3))
            n, hl = lens.long(), hls.long()
            plain = device_samples(lambda: mk.find_tokens_plain(
                blocks, n, hl, **params, lits_only=False), 2)
            fields.update(
                launches_per_group=mk.launches_per_group(False),
                plain_ms=summary([t * 1e3 for t in plain]),
                bound_ms=bound_ms, bound_by=bound_by)
            if busy is not None:
                k7_ms = trace["matched_busy_s"] / FIND_CALLS * 1e3
                fields.update(
                    k7_ms=k7_ms, sort_ms=busy / FIND_CALLS * 1e3 - k7_ms,
                    k7_ops=trace["matched_ops"] / FIND_CALLS,
                    k7_ms_by_kernel={
                        name: ms / FIND_CALLS for name, ms in trace.get(
                            "matched_ms", {}).items()},
                    bound_share=bound_ms / (busy / FIND_CALLS * 1e3),
                    top_device_ms=trace["top_device_ms"])
        return row(f"find_group_L{level}", "ms", [t * 1e3 for t in secs],
                   **fields)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch_device: no CUDA device; nothing was timed",
              file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from zippy_tpu_torch.ops import deflate_device as dd
    from zippy_tpu_torch.ops import kernel_build as kb

    groups = args.groups
    card = card_line()
    data = mixed_text(max(LABELS.values()), SEED)
    bench = Bench()
    if "start" in groups:
        bench.start(data)
    else:
        kb.build_all()
    if "transfers" in groups:
        bench.transfers()
    if "checksums" in groups:
        bench.checksums()
    if "decode" in groups:
        for label, n in LABELS.items():
            src = data[:n]
            blob = (dd.deflate(src, 6) if label == "mixed64mib"
                    else zlib.compress(src, 6)[2:-4])
            bench.decode(label, blob, src)
            torch.cuda.empty_cache()
    if "indexed" in groups:
        bench.indexed(data[:INDEXED_BYTES])
    if "encode" in groups:
        for level in LEVELS:
            bench.encode(level, data)
            torch.cuda.empty_cache()
    if "compress" in groups:
        bench.compress(data[:MAIN_BYTES])
    this = pathlib.Path(__file__).resolve().parent
    out = artifact(card, torch.cuda.get_device_name(0), bench.rows, groups,
                   None if root == this else str(root))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(card, flush=True)
    print(f"bench_torch_device: wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

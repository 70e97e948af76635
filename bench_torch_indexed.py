"""Where the time of zippy_tpu_torch's indexed decode goes, on one CUDA card.

    python3 bench_torch_indexed.py [--members MIB,...] [--reps N]

The payload is chip_smoke.py's seeded 64 MiB mixed payload at level 6. For
each member size it writes the stream with compress_device_indexed, then
prints one JSON line: the members and their tiles (the decode's own plan
of each member's index); `reps` timed uncompress_device(array=True) calls,
each split, by the call's profiling record, into the host's walk and
dispatch of every member and the one verification fetch after it (the
`checksum.wait` span of inflate_device.inflate_streams, which waits for
the card); one decode with the stages of every member
synchronized and summed; the functions with the most host seconds of one
decode under cProfile; and a torch.profiler trace of one decode (device
busy seconds, idle share, top kernels). First, as a yardstick in the same
run, the single-member gzip of the same payload decoded given its index,
`reps` times. Every decode is checked against the payload. Exits non-zero
without a CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import sys
import time

import torch

import chip_smoke


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _joined(parts) -> bytes:
    return b"".join(buf.cpu().numpy().tobytes() for buf, _ in parts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", default="1,8",
                    help="member sizes in MiB, comma-separated")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_indexed: no CUDA device", file=sys.stderr)
        return 2
    from zippy_tpu_torch import api, profiling
    from zippy_tpu_torch import gzip_format as gf
    from zippy_tpu_torch.ops import inflate_device as idev

    card = chip_smoke.card_line()
    data = chip_smoke.mixed_text(chip_smoke.MAIN_BYTES, chip_smoke.SEED)

    blob = api.compress(data, 6)
    indexes = gf.member_indexes(blob)
    given = []
    for _ in range(args.reps):
        out, sec = _timed(lambda: gf.uncompress_gzip_device_all(
            blob, indexes=indexes))
        chip_smoke.check(out == data, "single member given its index")
        given.append(sec)
    print(json.dumps({"run": "single member given its index", "card": card,
                      "tiles": sum(len(idev._plan_tiles(
                          i, idev._pick_cfg(i["total_out"])))
                          for _, i in indexes),
                      "seconds": given}), flush=True)

    dispatch = idev._dispatch
    for mib in (int(m) for m in args.members.split(",")):
        blob = gf.compress_device_indexed(data, 6, member_size=mib << 20)
        line = {"run": f"uncompress_device array=True, {mib} MiB members",
                "card": card, "compressed_bytes": len(blob)}
        seen = []

        def kept(data, index, *rest, **kw):
            seen.append(index)
            return dispatch(data, index, *rest, **kw)

        idev._dispatch = kept
        try:
            parts = gf.uncompress_device(blob, array=True)   # warm-up
        finally:
            idev._dispatch = dispatch
        chip_smoke.check(_joined(parts) == data, "warm-up decode")
        del parts
        line["members"] = len(seen)
        line["tiles"] = sum(len(idev._plan_tiles(
            i, idev._pick_cfg(i["total_out"]))) for i in seen)
        line["cfg_tile_out"] = sorted({idev._pick_cfg(i["total_out"]).tile_out
                                       for i in seen})
        line["dispatch_s"], line["verify_s"] = [], []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            was = profiling.enabled()
            profiling.enable()
            try:
                parts = gf.uncompress_device(blob, array=True)
            finally:
                (profiling.enable if was else profiling.disable)()
            rec = profiling.recent(1)[0]
            wait = rec.spans["checksum.wait"][2] / 1e9
            chip_smoke.check(_joined(parts) == data, "timed decode")
            del parts
            line["dispatch_s"].append((rec.end_ns - rec.start_ns) / 1e9
                                      - wait)
            line["verify_s"].append(wait)

        stages: dict = {}
        idev._dispatch = (
            lambda data, index, *rest, **kw:
            dispatch(data, index, *rest, **{**kw, "stages": stages}))
        try:
            parts, sec = _timed(lambda: gf.uncompress_device(blob,
                                                              array=True))
        finally:
            idev._dispatch = dispatch
        chip_smoke.check(_joined(parts) == data, "staged decode")
        del parts
        line["staged_seconds"] = sec
        line["stages_s"] = stages

        prof = cProfile.Profile()
        torch.cuda.synchronize()
        prof.enable()
        parts = gf.uncompress_device(blob, array=True)
        prof.disable()
        del parts
        stats = pstats.Stats(prof)
        top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:15]
        line["cprofile_top_tottime"] = [
            [f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}:{fn[2]}", st[2], st[1]]
            for fn, st in top]
        line["trace"] = chip_smoke.device_trace(
            lambda: gf.uncompress_device(blob, array=True))
        print(json.dumps(line), flush=True)
        del blob
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive zippy_tpu_torch's compress and decode paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure ends the run with a
non-zero exit and no result line):

1. the card (nvidia-smi's name and power limit, torch's device name);
2. the build of every native library, with its seconds: csrc/checksums.cu,
   csrc/inflate.cu, csrc/huffman.cu, csrc/resolve.cu, csrc/match.cu,
   csrc/pack.cu and csrc/join.cu with nvcc (started together), and the
   host engine with
   the decode's host scan, csrc/zippy_native.cpp, with c++;
   and what `nvcc -Xptxas -v` said of each kernel (registers, shared
   memory, spills);
3. kernels K1 (adler_chunks), K2 (crc_rows, on padded rows and in place
   with a tail row) and K3 (crc_combine) against their plain PyTorch
   versions on the card, and adler32/crc32 against zlib, at 0 B to
   256 MiB + 7 and on one unaligned view; at the largest size the kernels'
   times (K2 also on all-zero rows, which read no shared-memory bank
   twice) and the card's least time for the same work; K3 against its
   plain version at the edges of its lattice, blocks and meetings, on two
   streams at once and replayed from a CUDA graph (`crc_combine_edges`);
   then the `crc32_call` line: host ms per synchronized crc32_device call
   at 64 MiB, 256 MiB + 7 and on an unaligned 64 MiB view, and the device
   operations of one call, the most that three traces of it saw (3: K2,
   K3, the 4-byte copy of the raw CRC, which the host finishes; 4 on the
   view, whose aligned copy comes first);
4. the compress path: compress() of a seeded 64 MiB mixed text/binary
   payload to gzip at level 6, from host bytes and from a CUDA tensor, and
   of 8 MiB to zlib at levels 1 and 9; every stream decodes with CPython's
   gzip/zlib; the kernels' launch counts are zeroed before and read after
   (K5, K8 and K10 exactly once per encode group, K7 exactly
   launches_per_group times a group); K7 (match_tokens) against its plain
   version on every output
   of every group of the host-bytes encodes (inputs kept as its wrapper
   got them, `MatchWatch`) and on seeded rows (`match_rows`) at levels 1,
   6, 9, -1 and -2 with a full history and with none; one encode group
   issued under torch.cuda.set_sync_debug_mode("error"); K7's sort stage
   (`sort_keys`) against its plain version (`sort_keys_plain`, torch's
   sort) on the first group of the level-1, level-6 and level-9 encodes
   and on the level-6 and level-9 groups' shapes filled with zeros and
   with a 3-byte period (`k7_sort_vs_plain`: the sorted keys, each
   position's index in the order and min3's 3-gram candidates); K7 on the
   first full group of the level-6 and of the level-1 encode, its
   launches' device ms by stage (sort, match, walk, emit) and every device
   operation of the call its own (`match_split`), beside its plain
   version, torch.sort of the same keys and its bound (`find_work`), and
   on that level-6 group's shape filled with zeros and with a 3-byte
   period (`match_edge_groups`, against its plain version too); then one
   instrumented
   encode gives
   seconds per stage, and a torch.profiler trace of the encode gives device
   operations and the card's idle share; K5 (huffman_tables) against its
   plain version on every group of the host-bytes encodes (inputs kept as
   its wrapper got them) and on HUFFMAN_ROWS seeded rows of every edge
   kind, launched HUFFMAN_REPEATS times; traces of one K5 launch and one
   plain build of a full level-6 group; K8 (pack_tokens) against its plain
   version on every group of the host-bytes encodes (inputs kept as its
   wrapper got them, `PackWatch`) and on the edge cases of
   `pack_edge_inputs` (level -2, the fixed tables, stored rows, n < N,
   n = 1 and n = 0, 15-bit codes, 256-byte blocks, 65,521-byte blocks),
   every int32 word and bit count (`pack_tokens_vs_plain`); traces of one
   K8 launch and one plain pack of the first level-6 group; K10
   (join_rows) against its plain version on every group of the 64 MiB
   level-6 encode from host bytes (inputs kept as its wrapper got them,
   `JoinWatch`: the piece's bytes up to its last bit and the state row),
   and one K10 launch over the first level-6 group timed beside its bound
   (`join_work`); the traced 64 MiB level-6 compress's device operations
   a group;
5. the decode path: uncompress() of phase 4's 64 MiB gzip and 8 MiB zlib
   streams, of CPython's zlib level 6 of the 64 MiB payload, of a stored
   (level 0) stream and of a two-member gzip, each equal to its input, with
   the launch counts zeroed before and read after (K1-K4, K6 and K9 all
   launched, K4 and K9 once per batch of tiles that has a busy lane, K6
   launches_per_tile times a tile, K5, K7 and K8 never, the plain versions
   of K6 and K9 never); per
   stream the scan's seconds, the decode given its index (twice) and CPython's
   decompress; a decode given its index with no host sync from the first
   tile to the last (torch.cuda.set_sync_debug_mode("error")); the 64 MiB
   stream in batches of 8 tiles; a flipped crc raising ZippyError; one
   decode's synchronized stage seconds; a torch.profiler trace of a decode
   given its index, and of one tile decoded from its uploaded pack (K9,
   K4 and K6's launches); K4 against its plain version on every tile of
   all six streams, batched as the decode batches them, with the lanes
   whose block
   row K4 read from device memory rather than shared memory; one K4
   launch over the 64 MiB stream's batch timed, with its bound for the
   busy lanes and for the padded segment tables it wrote before; K6
   (lz_resolve) against its plain version on out[:HALO + used] of every
   tile of the six streams decoded given their indexes, with its launches
   equal to launches_per_tile's and within nrounds + 3 a tile
   (`ResolveWatch`), and K9 (block_tables) on every batch of the same
   decodes (`TablesWatch`: every element, one launch a batch) and on
   seeded corrupt code-length records (bytes above 15, over-subscribed,
   incomplete, all zeros), with one launch over the 64 MiB stream's
   first batch timed beside its bound and the launch floor
   (`block_tables`); K6 on the 64 MiB stream's first tile timed, with
   its bound (`resolve_work`); and K6 on a corrupt tile of each round
   shape (up to SMALL_TILE bytes and past it) whose tokens run past its
   bytes, which must write nothing past its bytes and its scratch
   (`k6_bounds`);
6. the indexed serving format (`indexed` lines), at 1 MiB and 8 MiB
   members of the 64 MiB payload at level 6: compress_device_indexed's
   seconds beside phase 4's single-member compress, its K5 launches (one a
   group of each member) and K7's, the stream's size and
   its sidecars' share, CPython's decode of it; uncompress_device (bytes
   and array=True) and uncompress() equal to the input with no scan call,
   their seconds beside the scanned uncompress() of phase 4's stream and
   CPython's decompress; the launch counts of one array=True decode (one
   K1 and one K2 + K3 per non-empty member, K4 once per batch with a busy
   lane, K6 launches_per_tile times a tile); the dispatch of every member
   under
   torch.cuda.set_sync_debug_mode("error") up to the one verification
   fetch; K4 against its plain version on every batch of that decode (at
   1 MiB members its tiles are CFG_S's, at 8 MiB CFG_L's), K6 on every
   tile and K9 on every batch of the same decode, with the first member's
   first tile timed; the
   same stream
   decoded the other way, every data member scanned and then decoded
   given its index; a flipped member crc and a flipped byte in a
   member's body raising ZippyError, and the intact stream decoding after
   them;
7. CPU and CUDA give the same raw DEFLATE bytes on 256 KiB at levels 1/6/9,
   and the same decode;
8. the multi-device layers (`parallel` lines), over default_devices() and
   over [cuda:0, cuda:0] (two shares on one card): deflate_sharded of the
   64 MiB payload at level 6 equal to phase 4's gzip L6 body, with seconds
   and peak memory; compress_gzip_sharded L1 and compress_zlib_sharded L9
   of 8 MiB decoded by CPython; crc32_sharded/adler32_sharded at 0 B,
   64 MiB and 256 MiB + 7 against zlib; inflate_device(devices=[cuda:0,
   cuda:0]) of the 64 MiB body; the launches of these runs, counted from
   zero (K1-K3 once per device share, K4 once per share with busy lanes
   per batch, K9 once a batch with busy lanes, K5 and K8 once per encode
   group of each device's run, K6 launches_per_tile times a tile, K7
   launches_per_group times an encode group), then K1-K3 on each 64 MiB
   share and K4 on each share of every batch against their plain
   versions, and K6 on every tile and K9 on every batch of the decode
   over [cuda:0, cuda:0]; two ranks spawned on gloo
   and cuda:0 (compress_gzip_all_hosts at level 6 of two 4 MiB shards,
   the same stream on both, decoded by CPython and by
   uncompress_gzip_all_hosts on the card); in a fresh process, warmup()
   cold and warm, then profiling.trace taken once around a decode, the
   process's first profiler session, naming K4's kernel; and the current
   device unchanged after every call. On a host with two cards or more
   the lists differ, the current device is checked after launches on
   other cards, and two more ranks run on NCCL, each on its own card;
9. the archive layer (`archives` lines), on a tree of 1,024 files in 64
   directories (log-normal sizes, median 16 KiB, sigma 1.5, clipped to
   [1 B, 8 MiB] and scaled to 64 MiB, cut from phase 4's payload, 1 file
   in 16 random bytes) and 8 empty files: create_zip_archive's seconds,
   ratio, rows and groups of its one batched encode, peak memory and
   launches, every entry read back by CPython's zipfile; 16 sampled
   entries' streams equal to deflate(entry, 1) alone, with those per-entry
   calls' seconds beside the batched call's; extract_all (seconds, the
   tree equal); a flipped central-directory crc32 raising ZippyError and
   leaving no destination; extract_file of a multi-block entry; the v1
   ZipArchive (add_dir, write_zip_archive, open) read by zipfile and the
   port; a .tgz from the v1 Tarball read by CPython's tarfile and
   extracted by tarballs.extract_all; the launches of all that, counted
   from zero (K5 and K8 once a group of the batched encode and K7
   launches_per_group times, none of them in a decode; K4 and K9 once a
   batch with busy lanes, K6 launches_per_tile times a tile of every
   deflated entry);
   torch.profiler traces of create_zip_archive and extract_all_zip of the
   tree's first 128 files; then K4 and K9 against their
   plain versions on every batch and K6 on every tile of 8 sampled
   entries' decodes, and K1-K3 on 8 entries against theirs;
10. the driver hooks (`driver_hooks` lines, zippy_tpu_torch.entry):
   entry("cuda")'s step (compress_block_fixed of one 64 KiB block) equal to
   entry("cpu")'s, words, bit count and both histograms, its packed block
   decoded by zlib behind a fixed-Huffman block header, no K5 launch, one
   group's K7 launches and one K8 launch (the fixed tables);
   dryrun_multichip(2, ["cuda:0", "cuda:0"]) and, on a host with two cards
   or more, dryrun_multichip over default_devices(), with seconds; their
   launches counted from zero (K1 for the decode's gate, K4 a share, K9
   a batch, K5, K7 and K8 a group of each encode, K6 for the decode); then
   K4 on their streams and K1-K3 on their data against the plain versions;
11. the host engine (`host_engine` lines, zippy_tpu_torch.native, the
   port's copy of zippy_tpu's C++ host codec): a cold build of
   csrc/zippy_native.cpp with its flags, timed, beside the CPU's model
   name and core count; compress(engine_name="native") of phase 4's
   payload cut to 8 MiB at levels -2, -1, 0, 1, 6 and 9 (seconds, MB/s,
   ratio), each stream decoded by CPython; of the 64 MiB payload at
   levels 1 and 6; uncompress(engine_name="native") and uncompress_gzip
   of phase 4's 64 MiB gzip L6 stream and of the host engine's own, each
   equal to the payload, their seconds and MB/s beside phase 4's and
   phase 5's card seconds on the same payload; no kernel launched by any
   of that; then uncompress(engine_name="device") of every host-engine
   stream on the card, counted from zero (K1-K4, K6 and K9 launched), and
   a flipped crc raising ZippyError on both engines; last, the SHA-256 of
   the raw DEFLATE body of each of phase 4's streams.

A kernel's time ("ms") is device time per launch, from a CUDA graph of
launches between CUDA events; a plain version's ("plain_ms") and a
wrapper's ("call_ms") are per call of the Python function. K4's numbers
are those of one launch over the 64 MiB stream's batch of tiles, K5's
those of one launch over the first group of the 64 MiB level-6 encode,
K7's those of one call's launches over the same group (from a profile of
10 calls, by stage in "ms_by_stage"; its "library_ms" is torch.sort of the
group's keys, the sort stage's yardstick, which the port never calls), K8's
those of one launch over the same group (its bound from the 32-byte
sectors its tokens and matches touch, "interface_bound_ms" from the
interface's whole arrays), K9's those of
one launch over the 64 MiB stream's first batch of tiles' records,
K6's those of one tile's launches on the 64 MiB stream's first tile (its
row's cfg_s_tile: a 1 MiB member's first tile; small_tile: a zip entry's
tile, the archive tree's text entry nearest its 16 KiB median, deflated
at level 1). A
kernel's "launches" in the kernel line are those of the compress run,
the decode run, the indexed compress and decode runs and the runs of
phases 8, 9, 10 and 11 together, each counted from zero just before its
run.
The launch floor ("launch_floor_ms", on the `kernel_calls` line and in K3's,
K5's and K9's rows) is the same timing of a one-element zero_() on the card.

After phase 11, the counts of K6's, K7's, K8's and K9's plain versions'
calls on CUDA tensors over the whole run, which must be 0. Then the kernel table (one JSON
line), the card's name and power limit, and last {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import gzip
import hashlib
import json
import os
import pathlib
import shutil
import socket
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "smoke"   # rank shards and streams, the trace
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
# 32-bit integer instructions (add, multiply-add, logic, shift) outside the
# tensor cores: 64 per clock per SM, 132 SMs, 1.98 GHz boost clock. The data
# sheet's 67e12 is float32 with a fused multiply-add counted as two.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
SEED = 20261016
MAIN_BYTES = 64 << 20
ZLIB_BYTES = 8 << 20
BIG_BYTES = (256 << 20) + 7    # phase 8's largest checksum payload
# The kernels a decode launches; an encode adds K5 (huffman_tables), K7
# (match_tokens) and K8 (pack_tokens).
DECODE_KERNELS = ("adler_chunks", "crc_rows", "crc_combine",
                  "block_tables", "inflate_extract", "lz_resolve")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what) -> None:
    """A failed check ends the run (no result line, non-zero exit)."""
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def mixed_text(n: int, seed: int) -> bytes:
    """Seeded payload: 3/4 Zipf-distributed words with punctuation, 1/8
    random bytes, 1/8 little-endian integer tables and byte runs, laid out
    in 64 KiB-scale segments so every block sees a mix."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, int(k)).astype(np.uint8))
             for k in rng.integers(1, 11, 20000)]
    vocab_np = np.array(vocab, dtype=object)
    seps = np.array([b" ", b" ", b" ", b" ", b", ", b". ", b"\n"],
                    dtype=object)
    out, total = [], 0
    while total < n:
        kind = rng.integers(0, 8)
        if kind < 6:
            idx = (rng.zipf(1.2, 12000) - 1) % len(vocab)
            sep = seps[rng.integers(0, len(seps), idx.size)]
            part = b"".join((vocab_np[idx] + sep).tolist())
        elif kind == 6:
            part = rng.integers(0, 256, int(rng.integers(4096, 65536)),
                                dtype=np.uint8).tobytes()
        else:
            ints = np.cumsum(rng.integers(0, 300, 8192)).astype("<u4")
            part = ints.tobytes() + bytes([int(rng.integers(0, 256))]) * int(
                rng.integers(100, 5000))
        out.append(part)
        total += len(part)
    return b"".join(out)[:n]


def call_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() over `reps` back-to-back calls,
    after one warm-up call, from CUDA events: the host's issue cost of each
    call counts."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int) -> float:
    """Device milliseconds per launch of fn(), a kernel wrapper: `reps`
    launches captured in one CUDA graph and replayed between CUDA events,
    so the wrapper's host work is not timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


# Host seconds inside a profile before fn() starts and after the card has
# finished it. The profiler keeps only the device events that lie inside its
# window, and a trace on the H100 once lacked the copy that opens an
# unaligned crc32_device call, issued at once after the profiler started.
TRACE_MARGIN_S = 0.005
# The first device activity of a profile can be lost while CUPTI takes its
# first activity buffer: on the H100, in a process that had run for a
# while, the profile of one K5 launch held its cudaLaunchKernel but no
# kernel, three times running, and a profile of zeros-K5-zeros lost the
# first zeros only. So a marker kernel (torch.cuda._sleep's spin_kernel)
# opens every profile, and is left out of its counts.
TRACE_MARKER = "spin_kernel"


def device_trace(fn, match: str | None = None) -> dict:
    """fn() under torch.profiler's CUDA tracing: wall seconds, the device
    operations it ran (kernels, copies, fills), their summed seconds, the
    share of the wall time in which the card ran none, and the six
    operation names with the most device ms (name, ms, count). A profile
    on the H100 has come back without any device event; the trace is then
    taken again, up to three times, and "tries" counts the profiles
    taken. The device numbers are null where the profiler saw no device
    work. The wall time leaves out the TRACE_MARGIN_S on either side, and
    the counts leave out the TRACE_MARKER kernel that opens the profile.
    With `match`, also the operations whose name holds it, their summed
    seconds and their ms by name (matched_ops, matched_busy_s,
    matched_ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(TRACE_MARGIN_S)
        ops = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and TRACE_MARKER not in e.name]
        if ops:
            break
    if not ops:
        return {"wall_s": wall, "tries": tries, "device_ops": None,
                "kernels": None, "device_busy_s": None,
                "device_idle_share": None}
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e6
    by_name: dict = {}
    for e in ops:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    matched = {} if match is None else {
        "matched_ops": sum(1 for e in ops if match in e.name),
        "matched_busy_s": sum(e.time_range.elapsed_us() for e in ops
                              if match in e.name) / 1e6,
        "matched_ms": {name: ms for name, (ms, _) in by_name.items()
                       if match in name}}
    return {"wall_s": wall, "tries": tries, "device_ops": len(ops),
            **matched,
            "kernels": sum(1 for e in ops
                           if not e.name.startswith(("Memcpy", "Memset"))),
            "device_busy_s": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "top_device_ms": [[name[:60], ms, count]
                              for name, (ms, count) in top]}


def adler_work(nchunks: int):
    """(bytes, operations) K1 must move and do: each byte read once, two
    int32 words written per chunk; an add and a multiply-add per byte."""
    return nchunks * 1024 + 8 * nchunks, 2 * nchunks * 1024


def crc_work(nrows: int):
    """(bytes, operations) K2 must move and do: each byte read once, one
    int32 written per row; one 32-bit operation per input word, the least
    any formulation needs to fold a word into its row's CRC (K2's table
    lookups take about 5 per byte)."""
    return nrows * 512 + 4 * nrows, nrows * 128


def combine_work(nrows: int):
    """(bytes, operations) K3 must move and do: each row CRC read once, one
    int32 written; one 32-bit operation per row."""
    return 4 * nrows + 4, nrows


def bound(work) -> tuple[float, str]:
    nbytes, nops = work
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The 32-bit operations (loads and stores included) that decoding one token
# needs, whatever the formulation: not K4's own instruction count. A
# literal (or end-of-block): the 64-bit window (word index, shift, two word
# loads, one funnel shift) 5, its litlen code by one table lookup (the
# peek, the load) 2, the entry's code length and literal test 2, the packed
# value, its address and store 3, the next bit position 1. A match adds
# its length's base and extra count 2 and extra bits (shift, mask, add) 3,
# the distance code's window shift 1, lookup 2, fields (length, base, extra
# count) 3 and extra bits 3, two more for the packed value and two more
# bit-position adds.
LITERAL_OPS = 5 + 2 + 2 + 3 + 1
MATCH_OPS = LITERAL_OPS + 2 + 3 + 1 + 2 + 3 + 3 + 2 + 2


def extract_work(words: int, nblk: int, nseg: int, lanes: int, k: int,
                 literals: int, matches: int):
    """(bytes, operations) K4 must move and do on one tile: the tile's
    stream words, its blocks' 382-word tables and its nseg busy segments'
    3-word records read once, the packed (k, lanes) output written once;
    and LITERAL_OPS per literal or end-of-block token, MATCH_OPS per match
    token, as this tile's data has them. `lanes` is nseg for the work the
    tile needs; the tile's full segment table (cfg.nseg, padding lanes
    included) gives the bound K4 was held to before it wrote busy lanes
    only."""
    return (4 * words + 4 * 382 * nblk + 12 * nseg + 4 * k * lanes,
            LITERAL_OPS * literals + MATCH_OPS * matches)


def resolve_work(k: int, lanes: int, nsto: int, stored_bytes: int,
                 halo: int, used: int, tokens: int):
    """(bytes, operations) K6 must move and do on one tile: its busy lanes'
    packed tokens (k a lane) and first output positions, its stored-span
    table (3 int32 a slot) with the stored bytes, and the halo read once;
    the halo + used bytes a caller reads written once. One operation a
    token and one an output byte (its store), the least any formulation
    does."""
    return (4 * k * lanes + 4 * lanes + 12 * nsto + stored_bytes + halo
            + halo + used, tokens + used)


# The fixed tables K5 reads once a launch: fixed_ll and its codes (286
# each), fixed_d and its codes (30 each), len_extra (29), dist_extra (30),
# clcl_order and cl_extra (19 each).
HUFFMAN_TABLE_WORDS = 2 * 286 + 2 * 30 + 29 + 30 + 2 * 19


def huffman_work(rows: int):
    """(bytes, operations) K5 must move and do for a group of `rows` rows:
    each row's histograms and byte count read once (317 int64) and its
    ten outputs written once (969 int64 and the header's 72 int32), the
    fixed tables read once; per row and per build of S symbols (litlen
    286, distance 30, code-length 19) the 30 bisection steps at 4
    operations a symbol (add, ceil, clamp,
    Kraft term), the two candidates' clamp and Kraft sum (8 a symbol), the
    frequency-rank order as a sort (2 log2 S a symbol) and the cost sums
    with the reassignment (4 a symbol); then 4 a symbol for each of the
    header's run-length pass, the mode's bit sums and the codes over the
    316 lengths. The repair passes are not counted (their number depends
    on the data): a least amount of work, not K5's own count."""
    ops = sum(s * (30 * 4 + 8 + 2 * (s - 1).bit_length() + 4)
              for s in (286, 30, 19)) + 3 * 4 * 316
    return (rows * ((317 + 969) * 8 + 72 * 4) + 8 * HUFFMAN_TABLE_WORDS,
            rows * ops)


def encode_groups(nbytes: int, level: int, shares: int = 1,
                  block_size: int = 1 << 16) -> int:
    """K5 launches of one encode of `nbytes` at `level` split over `shares`
    device runs (deflate_device.deflate_runs): one a group of _group_size
    blocks of each run."""
    from zippy_tpu_torch.ops import deflate_device as td

    if nbytes == 0 or level == 0:
        return 0
    nblocks = -(-nbytes // block_size)
    gmax = td._group_size(td._level_params(level)[0], block_size)
    bounds = [nblocks * i // shares for i in range(shares + 1)]
    return sum(-(-(b1 - b0) // gmax) for b0, b1 in zip(bounds, bounds[1:]))


def encode_launches(nbytes: int, level: int, shares: int = 1,
                    block_size: int = 1 << 16) -> dict:
    """K5's, K7's, K8's and K10's launches of one encode (encode_groups'
    groups): K5, K8 and K10 once a group, K7
    match_kernels.launches_per_group a group."""
    from zippy_tpu_torch.ops import match_kernels as mk

    groups = encode_groups(nbytes, level, shares, block_size)
    return {"huffman_tables": groups, "pack_tokens": groups,
            "join_rows": groups,
            "match_tokens": groups * mk.launches_per_group(level == -2)}


def find_work(rows: int, n_block: int, width: int, k: int, min3: bool):
    """(bytes, operations) K7 must move and do on a group of `rows` rows of
    `width` bytes holding `n_block`-byte blocks: the rows read once; the
    two bool and five int64 (G, N) outputs and the two int64 histograms
    written once; and the 32-bit word compares the reference makes at every
    position, whatever its data, one operation a word XOR and one a
    find-first-set of a scored candidate: for k >= 4 k ranks of NRANK
    words and three rescores of NWIN, else k scores of NWIN; the EXTW-word
    extension; min3's one 3-byte compare."""
    from zippy_tpu_torch.ops import match_kernels as mk

    if k >= 4:
        words, scored = k * mk.NRANK + 3 * mk.NWIN, k + 3
    else:
        words, scored = k * mk.NWIN, k
    per = words + scored + mk.EXTW + 1 + min3
    return (rows * width + rows * n_block * (2 + 5 * 8)
            + rows * (286 + 30) * 8, rows * n_block * per)


def sectors(mask: torch.Tensor) -> int:
    """The 32-byte sectors of a contiguous (G, N) int64 array, laid out as
    `mask`, that hold a position where `mask` is set: what reading the
    array at those positions alone moves."""
    flat = mask.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 4)])
    return int(flat.view(-1, 4).any(1).sum())


def pack_work(rows: int, n_block: int, tok: dict | None = None):
    """(bytes, operations) K8 must move and do on a group of `rows` rows of
    n_block positions. With the group's token cover `tok`, what its data
    needs: the two bools of every position, the 32-byte sectors of `sym`
    that hold a token and those of each of the four match fields that hold
    a match (K8 reads no other); without it, the interface's arrays, two
    bools and five int64 a position. Either way the (G, n_block // 2 + 8)
    int32 words and the int64 bit counts written once and the tables (two
    of 286 and two of 30 int64 a row, the four constant tables) read
    once.
    Operations: two a position (its two tests), four a token component
    (lookup, mask, shift, OR) and one a word stored."""
    wn = n_block // 2 + 8
    tables = rows * 2 * (286 + 30) * 8 + (29 + 29 + 30 + 30) * 8
    out = rows * (wn * 4 + 8)
    if tok is None:
        reads = rows * n_block * (2 + 5 * 8)
        tokens = matches = 0
    else:
        tokens, matches = (int(tok[key].sum()) for key in ("is_tok",
                                                           "is_match"))
        reads = rows * n_block * 2 + 32 * (sectors(tok["is_tok"])
                                           + 4 * sectors(tok["is_match"]))
    ops = 2 * rows * n_block + 4 * tokens + 12 * matches + rows * wn
    return reads + tables + out, ops


def tables_work(rows: int):
    """(bytes, operations) K9 must move and do for `rows` code-length
    records: each record's 318 bytes read once, its 382 int32 written once,
    the 318 entries read once; per symbol its clamp, its rank (a compare,
    a count) and its entry's address and store, 8 operations, and 16 sums
    of 15 terms a code."""
    return (rows * (318 + 382 * 4) + 318 * 8,
            rows * (318 * 8 + 2 * 16 * 15 * 2))


class PackWatch:
    """K8 (pack_tokens): the inputs its wrapper gets inside `keeping`, K8
    against its plain version on kept inputs (`vs_plain`), and, for the
    whole run, a count of the plain version's calls on CUDA tensors, which
    no encode path may make."""

    def __init__(self, pk):
        self.pk = pk
        self.plain = pk.pack_tokens_plain
        self.wrapper = pk.pack_tokens
        self.plain_cuda_calls = 0
        pk.pack_tokens_plain = self._counted_plain

    def _counted_plain(self, tok, *tables):
        self.plain_cuda_calls += tok["is_tok"].is_cuda
        return self.plain(tok, *tables)

    @contextlib.contextmanager
    def keeping(self, kept: list):
        """Appends (the token cover, the four tables) of every call,
        cloned."""
        def keep(tok, *tables):
            kept.append(({name: tok[name].clone()
                          for name, _ in self.pk.TOKEN_INPUTS},
                         [t.clone() for t in tables]))
            return self.wrapper(tok, *tables)

        self.pk.pack_tokens = keep
        try:
            yield kept
        finally:
            self.pk.pack_tokens = self.wrapper

    def vs_plain(self, inputs) -> dict:
        """K8 against its plain version (uncounted) on each (token cover,
        tables): groups, rows, K8's launches (one a group), differing words
        and bit counts and the largest difference, and the plain version's
        tokens, matches and bits."""
        from zippy_tpu_torch.ops import kernel_build as kb

        line = {"groups": 0, "rows": 0, "launches": 0,
                "differing_words": 0, "differing_total_bits": 0,
                "max_abs_err": 0, "tokens": 0, "matches": 0, "bits": 0}
        for tok, tables in inputs:
            before = kb.LAUNCHES["pack_tokens"]
            words, bits = self.wrapper(tok, *tables)
            line["launches"] += kb.LAUNCHES["pack_tokens"] - before
            want_words, want_bits = self.plain(tok, *tables)
            line["differing_words"] += int((words != want_words).sum())
            line["differing_total_bits"] += int((bits != want_bits).sum())
            line["max_abs_err"] = max(
                line["max_abs_err"],
                int((words.long() - want_words.long()).abs().max()),
                int((bits - want_bits).abs().max()))
            line["groups"] += 1
            line["rows"] += bits.shape[0]
            line["tokens"] += int(tok["is_tok"].sum())
            line["matches"] += int(tok["is_match"].sum())
            line["bits"] += int(want_bits.sum())
            del words, want_words
        return line

    @staticmethod
    def good(line) -> bool:
        return (line["groups"] > 0 and line["differing_words"] == 0
                and line["differing_total_bits"] == 0
                and line["max_abs_err"] == 0
                and line["launches"] == line["groups"])


def join_work(state_row, res: dict, lens: torch.Tensor) -> tuple:
    """(bytes, operations) K10 must move and do on a group: each row's bits
    read once (a stored row's bytes), the piece written once, four int64
    values a row read and the state row written; a few operations a word."""
    from zippy_tpu_torch.ops import join_kernels as jk

    mode, nbits, hdr = (res[key].cpu() for key in ("mode", "nbits",
                                                   "hdr_bits"))
    read = int(torch.where(mode == 0, lens.cpu(),
                           (3 + hdr + nbits + 7) // 8).sum())
    out = (int(state_row[jk.BITS]) + 7) // 8
    return read + out + 32 * len(mode) + 32, 8 * (read + out) // 4


class JoinWatch:
    """K10 (join_rows): the inputs its wrapper gets inside `keeping`, K10
    against its plain version on kept inputs (`vs_plain`), and, for the
    whole run, a count of the plain version's calls on CUDA tensors, which
    no encode path may make."""

    def __init__(self, jk):
        self.jk = jk
        self.plain = jk.join_rows_plain
        self.wrapper = jk.join_rows
        self.plain_cuda_calls = 0
        jk.join_rows_plain = self._counted_plain

    def _counted_plain(self, res, lens, *args):
        self.plain_cuda_calls += lens.is_cuda
        return self.plain(res, lens, *args)

    @contextlib.contextmanager
    def keeping(self, kept: list):
        """Appends (res, lens, raw, offset, block_size, last, the state,
        group) of every call, the tensors cloned as the call finds them on
        its stream (the state's start row written by the join before)."""
        def keep(res, lens, raw, offset, block_size, last, state, group):
            kept.append(({key: res[key].clone() for key in (
                "mode", "nbits", "hdr_bits", "hdr_words", "words")},
                lens.clone(), raw.clone(), offset, block_size, last,
                state.clone(), group))
            return self.wrapper(res, lens, raw, offset, block_size, last,
                                state, group)

        self.jk.join_rows = keep
        try:
            yield kept
        finally:
            self.jk.join_rows = self.wrapper

    @staticmethod
    def cpu(inputs) -> tuple:
        """A kept call's inputs copied to the CPU, the plain version's."""
        res, lens, raw, offset, block_size, last, state, group = inputs
        return ({key: v.cpu() for key, v in res.items()}, lens.cpu(),
                raw.cpu(), offset, block_size, last, state.cpu(), group)

    def run(self, inputs, plain: bool):
        """(the piece's bytes up to its last bit, the state row) of one
        kept call, by K10 or by the plain version on CPU copies."""
        if plain:
            inputs = self.cpu(inputs)
        res, lens, raw, offset, block_size, last, state, group = inputs
        if plain:
            piece = self.plain(res, lens, raw, offset, block_size, last,
                               state, group)
        else:
            state = state.clone()
            piece = self.wrapper(res, lens, raw, offset, block_size, last,
                                 state, group)
        row = state[group + 1].cpu()
        nbytes = (int(state[group, self.jk.PHASE]) + int(row[
            self.jk.BITS]) + 7) // 8
        return piece[:nbytes].cpu(), row

    def vs_plain(self, inputs) -> dict:
        """K10 against its plain version on each kept call: groups, rows,
        K10's launches (one a group), differing piece bytes and state
        values, the groups' bits and stored rows."""
        from zippy_tpu_torch.ops import kernel_build as kb

        line = {"groups": 0, "rows": 0, "launches": 0, "differing_bytes": 0,
                "differing_state": 0, "max_abs_err": 0, "bits": 0,
                "stored_rows": 0, "odd_phases": 0}
        for kept in inputs:
            before = kb.LAUNCHES["join_rows"]
            got, row = self.run(kept, False)
            line["launches"] += kb.LAUNCHES["join_rows"] - before
            want, want_row = self.run(kept, True)
            same = got.shape == want.shape
            line["differing_bytes"] += (int((got != want).sum()) if same
                                        else max(len(got), len(want)))
            line["differing_state"] += int((row != want_row).sum())
            line["max_abs_err"] = max(
                line["max_abs_err"], int((row - want_row).abs().max()),
                int((got.int() - want.int()).abs().max()) if same
                and len(got) else 0)
            line["groups"] += 1
            line["rows"] += kept[1].shape[0]
            line["bits"] += int(want_row[self.jk.BITS])
            line["stored_rows"] += int((kept[0]["mode"] == 0).sum())
            line["odd_phases"] += int(kept[6][kept[7], self.jk.PHASE]) % 2
        return line

    @staticmethod
    def good(line) -> bool:
        return (line["groups"] > 0 and line["differing_bytes"] == 0
                and line["differing_state"] == 0
                and line["max_abs_err"] == 0
                and line["launches"] == line["groups"])


ODD_BLOCK = 65_521     # pack_edge_inputs' block size, not a multiple of 16


def pack_edge_inputs(group, dev) -> dict:
    """K8's edge cases, {kind: (token cover, tables)}, from a kept K7 group
    (data_pad, n, hist_len, params) of the level-6 encode: all literals
    (level -2) with their own tables; the group's tokens with the fixed
    tables (the stored and fixed modes' and compress_block_fixed's); a
    stored-mode group of random bytes with the tables K5 gives it (the
    fixed ones); rows of n < N, n = 1 and n = 0 (the end-of-block code
    alone); every used symbol at 15 bits with random 15-bit codes, near
    the 16 N-bit worst case; a group of 256-byte blocks; and a group of
    65,521-byte blocks, a block size that is not a multiple of 16 (every
    other row's bools off a 16-byte boundary, and a partial thread at each
    row's end: K8's scalar path)."""
    from zippy_tpu_torch.ops import deflate_device as td
    from zippy_tpu_torch.ops import huffman_kernels as hk
    from zippy_tpu_torch.ops.device_tables import const

    data_pad, n, hist_len, params = group
    rows, width = data_pad.shape
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def cover(data, nn, hl, **over):
        tok = td.find_tokens(data, nn, hl, **{**params, **over})
        tab = hk.huffman_tables(tok["ll_hist"], tok["dist_hist"], nn)
        return tok, [tab[key] for key in ("use_ll", "ll_codes", "use_d",
                                          "d_codes")], tab["mode"]

    fixed = [const(name, dev)[None].expand(rows, -1) for name in (
        "fixed_ll", "fixed_ll_codes", "fixed_d", "fixed_d_codes")]
    tok, tables, _ = cover(data_pad, n, hist_len)
    fifteen = []
    for lens in (tables[0], tables[2]):
        fifteen.append(torch.where(lens > 0, 15, 0))
        fifteen.append(torch.randint(0, 1 << 15, tuple(lens.shape),
                                     generator=gen, device=dev))
    out = {"fixed tables": (tok, fixed), "15-bit codes": (tok, fifteen)}
    lits, lit_tables, _ = cover(data_pad, n, hist_len, lits_only=True)
    out["level -2"] = (lits, lit_tables)
    noise = torch.randint(0, 256, (rows, width), dtype=torch.uint8,
                          generator=gen, device=dev)
    tok, tables, mode = cover(noise, n, hist_len)
    check(bool((mode == 0).all()), "random rows are stored blocks")
    out["stored rows"] = (tok, tables)
    short = n.clone()
    short[0], short[1], short[2] = n[0] - 1000, 1, 0
    tok, tables, _ = cover(data_pad, short, hist_len)
    out["n < N, 1, 0"] = (tok, tables)
    small = data_pad[:, :td.HIST + 256 + td.PAD].contiguous()
    tok, tables, _ = cover(small, torch.full_like(n, 256), hist_len)
    out["256-byte blocks"] = (tok, tables)
    odd = data_pad[:, :td.HIST + ODD_BLOCK + td.PAD].contiguous()
    tok, tables, _ = cover(odd, torch.full_like(n, ODD_BLOCK), hist_len)
    check(tok["is_tok"].shape[1] == ODD_BLOCK, "the odd block size")
    out[f"{ODD_BLOCK}-byte blocks"] = (tok, tables)
    return out


class TablesWatch:
    """K9 (block_tables) held against its plain version on every batch of
    tables a decode builds inside `checking`; and, for the whole run, a
    count of the plain version's calls on CUDA tensors, which no decode
    path may make."""

    def __init__(self, ik):
        self.ik = ik
        self.plain = ik.block_tables_plain
        self.wrapper = ik.block_tables
        self.plain_cuda_calls = 0
        ik.block_tables_plain = self._counted_plain

    def _counted_plain(self, lens8):
        self.plain_cuda_calls += lens8.is_cuda
        return self.plain(lens8)

    def compare(self, lens8, line: dict) -> torch.Tensor:
        """K9 on lens8 against the plain version (uncounted), into line."""
        from zippy_tpu_torch.ops import kernel_build as kb

        before = kb.LAUNCHES["block_tables"]
        out = self.wrapper(lens8)
        line["launches"] += kb.LAUNCHES["block_tables"] - before
        want = self.plain(lens8.reshape(-1, 318))
        line["batches"] += 1
        line["rows"] += out.shape[0]
        line["differing_elements"] += int((out != want).sum())
        line["max_abs_err"] = max(line["max_abs_err"], int(
            (out.long() - want.long()).abs().max()) if out.numel() else 0)
        return out

    @staticmethod
    def new_line(label: str) -> dict:
        return {"run": label, "batches": 0, "rows": 0, "launches": 0,
                "differing_elements": 0, "max_abs_err": 0}

    @contextlib.contextmanager
    def checking(self, label: str):
        """Yields the line that K9's calls inside fill: batches, rows,
        launches (one a batch), differing elements, largest difference."""
        line = self.new_line(label)
        self.ik.block_tables = lambda lens8: self.compare(lens8, line)
        try:
            yield line
        finally:
            self.ik.block_tables = self.wrapper

    @staticmethod
    def good(line, batches: bool = True) -> bool:
        """Equal, one launch a batch, and (with `batches`) some batch."""
        return ((line["batches"] > 0 or not batches)
                and line["differing_elements"] == 0
                and line["max_abs_err"] == 0
                and line["launches"] == line["batches"])


def corrupt_lens8(dev) -> dict:
    """Seeded code-length records as a corrupt stream could leave them:
    any byte (above 15 too), over-subscribed codes, codes of lengths 10-15
    (incomplete), all zeros; on `dev`."""
    rng = np.random.default_rng(SEED)
    rows = {"bytes above 15": rng.integers(0, 256, (2048, 318)),
            "over-subscribed": rng.integers(1, 4, (2048, 318)),
            "incomplete": rng.integers(10, 16, (2048, 318)),
            "all zero": np.zeros((64, 318))}
    return {kind: torch.from_numpy(a.astype(np.uint8)).to(dev)
            for kind, a in rows.items()}


class MatchWatch:
    """K7 (match_tokens): the inputs its wrapper gets inside `keeping`,
    K7 against its plain version on kept inputs (`vs_plain`), and, for the
    whole run, a count of the plain version's calls on CUDA tensors, which
    no encode path may make."""

    def __init__(self, mk):
        self.mk = mk
        self.plain = mk.find_tokens_plain
        self.wrapper = mk.match_tokens
        self.plain_cuda_calls = 0
        mk.find_tokens_plain = self._counted_plain

    def _counted_plain(self, data_pad, *args, **kwargs):
        self.plain_cuda_calls += data_pad.is_cuda
        return self.plain(data_pad, *args, **kwargs)

    @contextlib.contextmanager
    def keeping(self, kept: list):
        """Appends (data_pad, n, hist_len, params) of every call, cloned."""
        def keep(data_pad, n, hist_len, **params):
            kept.append((data_pad.clone(), n.clone(), hist_len.clone(),
                         params))
            return self.wrapper(data_pad, n, hist_len, **params)

        self.mk.match_tokens = keep
        try:
            yield kept
        finally:
            self.mk.match_tokens = self.wrapper

    def vs_plain(self, inputs) -> dict:
        """K7 against its plain version (uncounted) on each kept input,
        every output element for element: groups, rows, K7's launches
        against launches_per_group, differing elements and the largest
        difference, and the tokens and matches of the plain version."""
        from zippy_tpu_torch.ops import kernel_build as kb

        line = {"groups": 0, "rows": 0, "launches": 0,
                "launches_expected": 0, "differing_elements": 0,
                "max_abs_err": 0, "tokens": 0, "matches": 0}
        for data_pad, n, hist_len, params in inputs:
            before = kb.LAUNCHES["match_tokens"]
            got = self.wrapper(data_pad, n, hist_len, **params)
            line["launches"] += kb.LAUNCHES["match_tokens"] - before
            line["launches_expected"] += self.mk.launches_per_group(
                params["lits_only"])
            want = self.plain(data_pad, n, hist_len, **params)
            for key, w in want.items():
                g = got[key]
                line["differing_elements"] += int((g != w).sum())
                if w.numel():
                    line["max_abs_err"] = max(line["max_abs_err"], int(
                        (g.long() - w.long()).abs().max()))
            line["groups"] += 1
            line["rows"] += data_pad.shape[0]
            line["tokens"] += int(want["is_tok"].sum())
            line["matches"] += int(want["is_match"].sum())
            del got, want
        return line

    @staticmethod
    def good(line) -> bool:
        return (line["groups"] > 0 and line["differing_elements"] == 0
                and line["max_abs_err"] == 0
                and line["launches"] == line["launches_expected"])


MATCH_LEVELS = (1, 6, 9, -1, -2)


def match_rows(seed: int, hist: int, n_block: int, rows: int) -> tuple:
    """Seeded rows for K7, (data_pad (rows, hist + n_block + PAD) uint8, n,
    hist_len (rows,) int64) numpy arrays, in turns of eight kinds: mixed
    text, all zeros (one hash bucket), a short period (ties of the rank),
    random bytes (no match), a 300-byte segment repeated (matches that
    reach 64 bytes and extend to 258), 3-grams repeated at short distances
    among random bytes (min3), the history's bytes repeated at distances
    about 32768 (the window's edge), and text after an unreal history
    whose bytes are not zeros (candidates there are not ok). The history
    is real in full, in part or not at all; the last row is short, and
    every row's bytes past n are real."""
    from zippy_tpu_torch.ops import match_kernels as mk

    rng = np.random.default_rng(seed)
    width = hist + n_block + mk.PAD
    text = np.frombuffer(mixed_text(width * rows, seed), np.uint8)
    data = np.zeros((rows, width), np.uint8)
    n = np.full(rows, n_block, np.int64)
    hist_len = np.full(rows, hist, np.int64)
    for i in range(rows):
        row, kind = data[i], i % 8
        if kind == 0:
            row[:] = text[i * width:(i + 1) * width]
        elif kind == 2:
            row[:] = np.resize(rng.integers(0, 256, int(rng.integers(1, 4)),
                                            dtype=np.uint8), width)
        elif kind == 3:
            row[:] = rng.integers(0, 256, width, dtype=np.uint8)
        elif kind == 4:
            seg = rng.integers(0, 256, 300, dtype=np.uint8)
            row[:] = np.resize(np.concatenate(
                [seg, rng.integers(0, 256, int(rng.integers(1, 60)),
                                   dtype=np.uint8)]), width)
        elif kind == 5:
            row[:] = rng.integers(0, 256, width, dtype=np.uint8)
            for p in range(0, width - 3, int(rng.integers(3, 9))):
                if rng.random() < 0.6:
                    row[p:p + 3] = (7, 8, 9)
        elif kind == 6:
            row[:] = rng.integers(0, 256, width, dtype=np.uint8)
            for back in (32768, 32767, 32769):
                at = int(rng.integers(hist, width - 600))
                if at >= back:
                    row[at:at + 600] = row[at - back:at - back + 600]
        elif kind == 7:
            row[:] = text[i * width:(i + 1) * width]
            hist_len[i] = int(rng.integers(0, hist + 1))
        if kind == 1:
            hist_len[i] = 0
        elif kind == 2:
            hist_len[i] = hist // 2
    n[-1] = int(rng.integers(1, n_block // 3))
    return data, n, hist_len


def match_vs_plain_rows(watch: MatchWatch, td, dev) -> dict:
    """K7 against its plain version on match_rows at every level of
    MATCH_LEVELS (-1 as level 6, -2 as lits_only), with a full history and
    with none, 16 rows each."""
    lines = {}
    for hist in (td.HIST, 0):
        data, n, hist_len = (torch.from_numpy(a).to(dev) for a in match_rows(
            SEED + hist, hist, td.BLOCK, 16))
        for level in MATCH_LEVELS:
            k, lazy, min3 = td._level_params(1 if level == -2 else level)
            params = {"k": k, "lazy": lazy, "hist": hist, "min3": min3,
                      "lits_only": level == -2}
            lines[f"L{level} hist {hist}"] = watch.vs_plain(
                [(data, n, hist_len, params)])
    return lines


def match_edge_groups(group):
    """(kind, group) for K7's edge cases at a kept group's shape: its rows
    all zeros, and a random 3-byte period, n and hist_len unchanged."""
    data_pad, n, hist_len, params = group
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    period = torch.randint(0, 256, (3,), dtype=torch.uint8, generator=gen)
    width = data_pad.shape[1]
    rows = period.repeat(-(-width // 3))[:width].expand_as(data_pad)
    return [("zeros", (torch.zeros_like(data_pad), n, hist_len, params)),
            ("period 3", (rows.to(data_pad.device).contiguous(), n, hist_len,
                          params))]


# K7's kernels by stage, for match_split's "ms_by_stage".
K7_STAGES = (("sort", ("k7_count", "k7_scan", "k7_scatter", "k7_hist")),
             ("match", ("k7_match",)), ("walk", ("k7_exits", "k7_chain")),
             ("emit", ("k7_emit", "k7_literals")))


def match_split(watch: MatchWatch, inputs, reps: int) -> dict:
    """K7 on one kept group: the device ms of its launches a call, and by
    stage, from one profile of `reps` calls, with the device ms and
    operations of the call that are not K7's ("sort_ms": the library
    sort's in older trees; 0 now); the call's ms from CUDA events (the
    host's issue counted); the plain version's ms; torch.sort of the same
    keys ("library_ms", from a profile); the bound (find_work)."""
    data_pad, n, hist_len, params = inputs
    rows, width = data_pad.shape
    n_block = width - params["hist"] - watch.mk.PAD

    def call():
        return watch.wrapper(data_pad, n, hist_len, **params)

    trace = device_trace(lambda: [call() for _ in range(reps)],
                         match="k7_")
    keys = watch.mk.hash_keys_plain(data_pad, params["min3"])
    library = device_trace(lambda: [torch.sort(keys, dim=1)
                                    for _ in range(reps)])
    del keys
    bound_ms, bound_by = bound(find_work(rows, n_block, width, params["k"],
                                         params["min3"]))
    line = {"rows": rows, "k": params["k"], "min3": params["min3"],
            "launches_per_group": watch.mk.launches_per_group(
                params["lits_only"]),
            "call_ms": call_ms(call, reps),
            "plain_ms": call_ms(lambda: watch.plain(data_pad, n, hist_len,
                                                    **params), 2),
            "library_ms": None if library["device_busy_s"] is None
            else library["device_busy_s"] / reps * 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "trace_device_ops_per_call": None, "ms": None, "sort_ms": None}
    if trace["device_busy_s"] is not None:
        line["ms"] = trace["matched_busy_s"] / reps * 1e3
        line["sort_ms"] = (trace["device_busy_s"]
                           - trace["matched_busy_s"]) / reps * 1e3
        line["trace_device_ops_per_call"] = trace["device_ops"] / reps
        line["k7_ops_per_call"] = trace["matched_ops"] / reps
        line["ms_by_stage"] = {
            stage: sum(ms for name, ms in trace["matched_ms"].items()
                       if any(kernel in name for kernel in kernels)) / reps
            for stage, kernels in K7_STAGES}
        line["bound_share"] = bound_ms / (line["ms"] + line["sort_ms"])
        line["top_device_ms"] = trace["top_device_ms"]
    return line


def sort_vs_plain(mk, groups) -> dict:
    """K7's sort stage (sort_keys) against its plain version
    (sort_keys_plain) on each group's rows: groups, rows, launches against
    LAUNCHES_SORT a group, and the differing elements of the sorted keys
    and of each block position's index in the order and, under min3, of
    the 3-byte keys, their order's indexes and the 3-gram candidates
    k7_match reads from them (candidates3)."""
    from zippy_tpu_torch.ops import kernel_build as kb

    line = {"groups": 0, "rows": 0, "launches": 0, "launches_expected": 0,
            "differing_elements": {}}
    diff = line["differing_elements"]
    for data_pad, _, _, params in groups:
        before = kb.LAUNCHES["match_tokens"]
        got = mk.sort_keys(data_pad, params["hist"], params["min3"])
        line["launches"] += kb.LAUNCHES["match_tokens"] - before
        line["launches_expected"] += mk.LAUNCHES_SORT
        want = mk.sort_keys_plain(data_pad, params["hist"], params["min3"])
        if params["min3"]:
            got["c3"] = mk.candidates3(got["keys3"], got["inv3"])
        for key, w in want.items():
            diff[key] = diff.get(key, 0) + int(
                (got[key].long() != w.long()).sum())
        line["groups"] += 1
        line["rows"] += data_pad.shape[0]
        del got, want
    return line


HUFFMAN_ROWS = 4096
HUFFMAN_REPEATS = 20      # K5 launches on the seeded rows, each checked


def huffman_rows(count: int, seed: int):
    """`count` seeded rows for K5, (ll_hist (count, 286), dist_hist (count,
    30), n (count,)) int64 numpy arrays, in turns of ten kinds: Zipf,
    dyadic, uniform over all 286 symbols, none active, one active, two
    active, frequencies about the sort keys' 2^20 clamp, three at 2^22, a
    few small literals (fixed blocks) and flat literals (stored blocks
    where n is the literal count); a random distance histogram in 7 rows
    of 10, and n either random or the literal count."""
    rng = np.random.default_rng(seed)
    ll = np.zeros((count, 286), np.int64)
    d = np.zeros((count, 30), np.int64)
    n = np.zeros(count, np.int64)
    for i in range(count):
        row, s = ll[i], int(rng.integers(2, 287))
        kind = i % 10
        if kind == 0:
            row[:s] = rng.zipf(1.3, s) % 4096
        elif kind == 1:
            row[:s] = 2 ** rng.integers(0, 16, s)
        elif kind == 2:
            row[:] = rng.integers(1, 1000, 286)
        elif kind == 4:
            row[int(rng.integers(0, 286))] = int(rng.integers(1, 1 << 16))
        elif kind == 5:
            row[rng.choice(286, 2, replace=False)] = rng.integers(1, 5000, 2)
        elif kind == 6:
            row[:s] = rng.integers((1 << 20) - 64, (1 << 20) + 64, s)
        elif kind == 7:
            row[:s] = rng.integers(1, 100, s)
            row[rng.choice(286, 3, replace=False)] = 1 << 22
        elif kind == 8:
            row[:int(rng.integers(1, 6))] = rng.integers(1, 20)
        elif kind == 9:
            row[:256] = rng.integers(200, 300, 256)
        rng.shuffle(row)
        if rng.random() < 0.7:
            k = int(rng.integers(0, 31))
            d[i, :k] = rng.integers(0, 500, k)
            rng.shuffle(d[i])
        n[i] = (rng.integers(0, 1 << 17) if rng.random() < 0.5
                else row.sum())
    return ll, d, n


def huffman_vs_plain(hk, td, inputs, repeats: int = 1) -> dict:
    """K5 against its plain version (torch.equal on every output) on each
    (ll_hist, dist_hist, n) of `inputs`, K5 launched `repeats` times on
    each (a race between a row's threads would show as launches that
    differ): the launches and rows, the blocks of each mode (stored, fixed,
    dynamic) the plain version chose, and the largest difference."""
    line = {"launches": 0, "rows": 0, "modes": [0, 0, 0],
            "equal_plain": True, "max_abs_err": 0}
    for ll, d, n in inputs:
        want = td.huffman_tables_plain(ll, d, n)
        for _ in range(repeats):
            got = hk.huffman_tables(ll, d, n)
            for key, w in want.items():
                line["equal_plain"] &= bool(torch.equal(got[key], w))
                line["max_abs_err"] = max(line["max_abs_err"], int(
                    (got[key] - w).abs().max()))
            line["launches"] += 1
        line["rows"] += ll.shape[0]
        modes = torch.bincount(want["mode"], minlength=3).tolist()
        line["modes"] = [a + b for a, b in zip(line["modes"], modes)]
    return line


CALL_TRACES = 3


def crc32_call(tc, x: torch.Tensor, reps: int) -> dict:
    """Host-clock ms per crc32_device(x) call, x a CUDA tensor (each call
    ends in a copy of the result to the host, so it is synchronized), and
    the device operations of one call from CALL_TRACES traces of it, each
    trace's count listed. A trace can miss an event but not add one (no
    other work runs on the card), so the call's count is the most that a
    trace saw, and its other numbers are that trace's."""
    tc.crc32_device(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tc.crc32_device(x)
    ms = (time.perf_counter() - t0) / reps * 1e3
    traces = [device_trace(lambda: tc.crc32_device(x))
              for _ in range(CALL_TRACES)]
    trace = max(traces, key=lambda t: t["device_ops"] or 0)
    return {"bytes": x.numel(), "aligned": x.data_ptr() % 16 == 0,
            "ms": ms, "device_ops": trace["device_ops"],
            "device_ops_per_trace": [t["device_ops"] for t in traces],
            "kernels": trace["kernels"],
            "trace_tries": [t["tries"] for t in traces],
            "device_busy_ms": None if trace["device_busy_s"] is None
            else trace["device_busy_s"] * 1e3}


def launch_floor_ms(dev) -> float:
    """kernel_ms of the least kernel there is: an in-place zero_() of one
    int32 on the card. A kernel whose work is below it is bound by its
    launch, and its share of this floor says more than that of its bound."""
    z = torch.empty(1, dtype=torch.int32, device=dev)
    return kernel_ms(lambda: z.zero_(), 100)


# K3's edges (full rows, + 1 for the last row): one row; one block's 64
# lanes +- 1; one block's 4 rows a lane +- 1; one group of 32 blocks at 4
# rows a lane +- 1 (two meetings from 8194 rows on); the largest grid's
# lattice stride of 32768 lanes +- 1; the 64 MiB trailer's 131072 rows +- 1.
COMBINE_EDGE_ROWS = (1, 64, 65, 66, 256, 257, 258, 8192, 8193, 8194, 32768,
                     32769, 32770, 131071, 131072, 131073)


def combine_edges_phase(ck, dev, gen) -> None:
    """K3 against its plain version (torch.equal) on random row CRCs at the
    edges of its lattice, blocks and meetings, each with a random last row
    length, and at 131073 rows with last rows of 1, 3, 511 and 512 bytes;
    then two calls at once on two streams, 50 times over, and one call
    captured in a CUDA graph and replayed, each against the plain."""
    def rand_crcs(nrows: int) -> torch.Tensor:
        return torch.randint(0, 1 << 32, (nrows,), dtype=torch.int64,
                             device=dev, generator=gen).to(torch.int32)

    edges = []
    cases = [(n, int(torch.randint(1, ck.CRC_ROW_BYTES + 1, (1,), device=dev,
                                   generator=gen)))
             for n in COMBINE_EDGE_ROWS]
    for nrows, last in cases + [(131073, v) for v in (1, 3, 511, 512)]:
        c = rand_crcs(nrows)
        edges.append({"rows": nrows, "last_bytes": last,
                      "blocks": 1 << ck._combine_lg(nrows - 1),
                      "equal_plain": bool(torch.equal(
                          ck.crc_combine(c, last),
                          ck.crc_combine_plain(c, last)))})
    a, b = rand_crcs(131072), rand_crcs(131073)
    want_a, want_b = ck.crc_combine_plain(a), ck.crc_combine_plain(b, 7)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    same = True
    for _ in range(50):
        with torch.cuda.stream(streams[0]):
            got_a = ck.crc_combine(a)
        with torch.cuda.stream(streams[1]):
            got_b = ck.crc_combine(b, 7)
        torch.cuda.synchronize()
        same &= bool(torch.equal(got_a, want_a) and torch.equal(got_b, want_b))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_g = ck.crc_combine(b, 7)
    got_g.zero_()
    graph.replay()
    torch.cuda.synchronize()
    line = {"phase": "crc_combine_edges", "edges": edges,
            "two_streams_equal_plain": same,
            "graph_replay_equal_plain": bool(torch.equal(got_g, want_b))}
    emit(line)
    check(all(e["equal_plain"] for e in edges) and same
          and line["graph_replay_equal_plain"], line)


def _member_indexes(idev, gzip_format, blob: bytes, fmt: str) -> list:
    """[(byte offset, decode index)] of each member of a gzip stream, or of
    the one zlib stream."""
    if fmt == "zlib":
        return [(0, idev.build_decode_index(blob, 16))]
    return gzip_format.member_indexes(blob)


def _decode_given(idev, gzip_format, blob: bytes, fmt: str,
                  indexes: list) -> bytes:
    from zippy_tpu_torch import api

    if fmt == "zlib":
        return api.uncompress_zlib_device(blob, indexes[0][1])
    return gzip_format.uncompress_gzip_device_all(blob, indexes=indexes)


def _batches(idev, tiles) -> list:
    """The tiles in the decode's batches of up to _TILES_PER_LAUNCH."""
    cap = idev._TILES_PER_LAUNCH
    return [tiles[b:b + cap] for b in range(0, len(tiles), cap)]


def _k4_launches(idev, index) -> int:
    """K4 launches one decode of `index` makes: one per batch that has a
    busy lane."""
    tiles = idev._plan_tiles(index, idev._pick_cfg(index["total_out"]))
    return sum(any(t.s1 > t.s0 for t in batch)
               for batch in _batches(idev, tiles))


def _k4_inputs(idev, blob: bytes, index, dev, keep: list):
    """K4's inputs for each batch of one decode index, as the decode forms
    them: (tile config, the batch's tiles, each tile's end word in the
    stream, words, seg, busy lanes, tables) on `dev`."""
    cfg = idev._pick_cfg(index["total_out"])
    tiles = idev._plan_tiles(index, cfg)
    ends = [t.w0 for t in tiles[1:]] + [-(-index["end_bit"] // 32)]
    b = 0
    for batch in _batches(idev, tiles):
        packs = idev._upload_packs(
            [idev._tile_pack(blob, index, t, cfg,
                             idev._nrounds_for_depth(t.depth, cfg))
             for t in batch], dev, keep)
        words, seg, _, _, lens8 = idev._unpack(packs, cfg)
        yield (cfg, batch, ends[b:b + len(batch)], words, seg,
               [t.s1 - t.s0 for t in batch],
               idev._block_tables(lens8.reshape(-1, 318)))
        b += len(batch)


def k4_against_plain(idev, ik, label: str, blob: bytes, indexes, dev):
    """K4 against its plain version (torch.equal) on every batch of tiles
    of each decode index of one stream, batched as the decode batches
    them, with the tile sizes it met and the lanes whose block row K4 did
    not stage. Returns the stream's line and its first batch with a busy
    lane (cfg, batch, ends, words, seg, used, tables, k, plain, index)."""
    line = {"run": label, "tiles": 0, "batches": 0, "busy_lanes": 0,
            "tile_bytes": [], "equal_plain": True, "max_abs_err": 0}
    off_run = torch.zeros(1, dtype=torch.int64, device=dev)
    keep: list = []
    first = None
    for _, index in indexes:
        k = index["every"]
        for cfg, batch, ends, words, seg, used, tables in _k4_inputs(
                idev, blob, index, dev, keep):
            line["tiles"] += len(batch)
            if cfg.tile_out not in line["tile_bytes"]:
                line["tile_bytes"].append(cfg.tile_out)
            if not sum(used):
                continue
            line["batches"] += 1
            line["busy_lanes"] += sum(used)
            got = ik.inflate_extract(words, seg, used, tables, k, off_run)
            plain = ik._extract_plain(words, seg, used, tables, k)
            line["equal_plain"] &= bool(torch.equal(got, plain))
            line["max_abs_err"] = max(line["max_abs_err"], int(
                (got.long() - plain.long()).abs().max()))
            if first is None:
                first = (cfg, batch, ends, words, seg, used, tables, k,
                         plain, index)
            del got
    line["off_run_lanes"] = int(off_run.item())
    return line, first


def k4_phase(idev, ik, streams, all_indexes, dev) -> dict:
    """K4 against its plain version on every tile of every stream; then
    one launch over the first stream's first batch timed, with its bound
    for the busy lanes and for the padded segment tables. Returns K4's row
    for the kernel line (launches filled in by the caller)."""
    lines, first = [], None
    for label, blob, _, _ in streams:
        line, batch = k4_against_plain(idev, ik, label, blob,
                                       all_indexes[label], dev)
        lines.append(line)
        if first is None and batch is not None:
            first = (*batch, label)
    emit({"phase": "inflate_extract_streams", "streams": lines})
    check(all(line["equal_plain"] for line in lines), "K4 differs from plain")

    cfg, batch, ends, words, seg, used, tables, k, plain, index, label = first
    bases, ncta = ik._bases(used, dev)
    out = torch.empty_like(plain)
    ms = kernel_ms(lambda: ik._launch(words, seg, bases, ncta, tables, k,
                                      out), 100)
    plain_ms = call_ms(lambda: ik._extract_plain(words, seg, used, tables,
                                                 k), 1)
    per_tile, busy, padded = [], [0, 0], [0, 0]
    col = 0
    for tile, end, n in zip(batch, ends, used):
        tokens = int(index["segments"][tile.s0:tile.s1, 3].sum())
        matches = int(((plain[:, col:col + n] & 0xFFFF) >= 256).sum())
        col += n
        args = (end - tile.w0 + 1, tile.b1 - tile.b0, n)
        w_busy = extract_work(*args, n, k, tokens - matches, matches)
        w_pad = extract_work(*args, cfg.nseg, k, tokens - matches, matches)
        per_tile.append({"segments": n, "tokens": tokens, "matches": matches,
                         "bound_ms": bound(w_busy)[0],
                         "padded_bound_ms": bound(w_pad)[0]})
        for i in (0, 1):
            busy[i] += w_busy[i]
            padded[i] += w_pad[i]
    bound_ms, bound_by = bound(busy)
    pad_ms, pad_by = bound(padded)
    n = len(batch)
    emit({"phase": "inflate_extract_batch", "run": label, "tiles": n,
          "busy_lanes": sum(used), "ms_per_launch": ms, "ms_per_tile": ms / n,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bound_ms_per_tile": bound_ms / n, "share_of_bound": bound_ms / ms,
          "padded_bound_ms": pad_ms, "padded_bound_by": pad_by,
          "padded_bound_ms_per_tile": pad_ms / n, "plain_ms": plain_ms,
          "per_tile": per_tile})
    return {"name": "inflate_extract", "route": "cuda",
            "source": "zippy_tpu_torch/csrc/inflate.cu",
            "replaces": "zippy_tpu/ops/inflate_device.py:268",
            "launches": None,
            "max_abs_err": max(line["max_abs_err"] for line in lines),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


class ResolveWatch:
    """K6 (lz_resolve) held against its plain version on every tile that a
    decode resolves inside `checking`, on out[:HALO + used] (every byte a
    caller reads); and, for the whole run, a count of the plain version's
    calls on CUDA tensors, which no decode path may make."""

    def __init__(self, rk):
        self.rk = rk
        self.plain = rk._resolve_plain
        self.wrapper = rk.lz_resolve
        self.plain_cuda_calls = 0
        rk._resolve_plain = self._counted_plain

    def _counted_plain(self, packed, *rest):
        self.plain_cuda_calls += packed.is_cuda
        return self.plain(packed, *rest)

    def plain_of(self, packed, seg_out, words, sto, halo, used, nrounds,
                 cfg):
        """The plain version on the wrapper's arguments (uncounted)."""
        return self.plain(packed, seg_out, words, self.rk.stored_spans(sto),
                          halo, nrounds, cfg)

    @contextlib.contextmanager
    def checking(self, label: str):
        """Yields the line that K6's calls inside fill: tiles, differing
        bytes and the largest difference, K6's launches, the
        launches_per_tile sum they must equal and their budget (nrounds + 3
        a tile)."""
        from zippy_tpu_torch.ops import kernel_build as kb

        line = {"run": label, "tiles": 0, "differing_bytes": 0,
                "max_abs_err": 0, "launches": 0, "launches_expected": 0,
                "launch_budget": 0}

        def checked(*args):
            before = kb.LAUNCHES["lz_resolve"]
            out = self.wrapper(*args)
            line["launches"] += kb.LAUNCHES["lz_resolve"] - before
            line["launches_expected"] += self.rk.launches_per_tile(args[6],
                                                                   args[5])
            line["launch_budget"] += args[6] + 3
            n = self.rk.HALO + args[5]
            got, want = out[:n].int(), self.plain_of(*args)[:n].int()
            line["tiles"] += 1
            line["differing_bytes"] += int((got != want).sum())
            line["max_abs_err"] = max(line["max_abs_err"],
                                      int((got - want).abs().max()))
            return out

        self.rk.lz_resolve = checked
        try:
            yield line
        finally:
            self.rk.lz_resolve = self.wrapper

    @staticmethod
    def good(line) -> bool:
        return (line["tiles"] > 0 and line["differing_bytes"] == 0
                and line["launches"] == line["launches_expected"]
                and 0 < line["launches"] <= line["launch_budget"])


def _k6_launches(idev, rk, index) -> int:
    """K6 launches one decode of `index` makes: launches_per_tile of each
    tile's rounds and bytes."""
    cfg = idev._pick_cfg(index["total_out"])
    return sum(rk.launches_per_tile(idev._nrounds_for_depth(t.depth, cfg),
                                    t.used)
               for t in idev._plan_tiles(index, cfg))


def k6_tile(idev, ik, watch, label: str, blob: bytes, index, dev) -> dict:
    """K6 on the first tile of a decode index, its inputs as the decode
    forms them (K4 on the tile, a zero halo): against its plain version,
    its hops a round and its launches, counted, which must be
    launches_per_tile's, its device ms for the tile's launches from a CUDA
    graph, the plain version's ms on the card, and its bound."""
    from zippy_tpu_torch.ops import kernel_build as kb

    rk = watch.rk
    cfg = idev._pick_cfg(index["total_out"])
    tile = idev._plan_tiles(index, cfg)[0]
    nrounds = idev._nrounds_for_depth(tile.depth, cfg)
    keep: list = []
    packs = idev._upload_packs(
        [idev._tile_pack(blob, index, tile, cfg, nrounds)], dev, keep)
    words, seg, seg_out, sto, lens8 = idev._unpack(packs, cfg)
    lanes, k = tile.s1 - tile.s0, int(index["every"])
    packed = ik.inflate_extract(words, seg, [lanes], idev._block_tables(
        lens8.reshape(-1, 318)), k)
    halo = torch.zeros(rk.HALO, dtype=torch.uint8, device=dev)
    args = (packed, seg_out[0, :lanes], words[0], sto[0], halo, tile.used,
            nrounds, cfg)
    n = rk.HALO + tile.used
    before = kb.LAUNCHES["lz_resolve"]
    got = rk.lz_resolve(*args)[:n]
    made = kb.LAUNCHES["lz_resolve"] - before
    diff = int((got != watch.plain_of(*args)[:n]).sum())
    spans = rk.stored_spans(sto[0])
    tokens = int(index["segments"][tile.s0:tile.s1, 3].sum())
    bound_ms, bound_by = bound(resolve_work(
        k, lanes, cfg.nsto, sum(min(ln, rk.STO_MAX) for *_, ln in spans),
        rk.HALO, tile.used, tokens))
    ms = kernel_ms(lambda: rk.lz_resolve(*args), 20)
    launches = rk.launches_per_tile(nrounds, tile.used)
    line = {"run": label, "tile_bytes": cfg.tile_out, "used": tile.used,
            "busy_lanes": lanes, "tokens": tokens,
            "stored_spans": len(spans), "nrounds": nrounds,
            "hops_per_round": rk.hops_per_round(tile.used),
            "launches": launches, "launches_counted": made,
            "launch_budget": nrounds + 3,
            "differing_bytes": diff, "ms": ms,
            "ms_per_launch": ms / launches,
            "plain_ms": call_ms(lambda: watch.plain_of(*args), 2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms}
    del keep
    check(diff == 0 and made == launches and launches <= nrounds + 3, line)
    return line


# What K6's scratch and output hold, in k6_bounds, where it may not write.
LINK_SENTINEL = 0x5A5A5A5A
OUT_SENTINEL = 0xA5
CORRUPT_LANE_BYTES = 1 + 31 * 258   # a literal and 31 matches at distance 1


def _k6_corrupt(idev, watch, dev, cfg, used: int) -> dict:
    """K6 on a corrupt tile of `used` bytes: lanes of a literal ("A") and
    31 matches of 258 bytes at distance 1, end to end from the tile's first
    byte, the last running past `used`; then a lane of literals ("B")
    that starts past the tile, one past 2^31 - 300 and one at -2^31, as a
    corrupt stream or a hostile index gives them. The entry point is
    called with its output filled with OUT_SENTINEL and its scratch (the
    tile's int32 states) at the front of a larger buffer filled with
    LINK_SENTINEL: it must equal its plain version on out[:HALO + used],
    make launches_per_tile's launches, and leave out[HALO + used:] and the
    buffer's tail as they were."""
    rk = watch.rk
    k, lanes = 32, -(-used // CORRUPT_LANE_BYTES)
    out_pad = rk.HALO + cfg.tile_out
    packed = torch.zeros(k, lanes + 3, dtype=torch.int32)
    packed[0] = (1 << 16) | 0x41
    packed[1:] = (258 << 16) | (1 + 256)
    packed[:, lanes] = (1 << 16) | 0x42
    seg_out = torch.tensor(
        [rk.HALO + CORRUPT_LANE_BYTES * i for i in range(lanes)]
        + [rk.HALO + used + 5000, 2**31 - 300, -2**31], dtype=torch.int32)
    sto = torch.zeros(3, cfg.nsto, dtype=torch.int32)
    sto[1] = out_pad
    gen = torch.Generator().manual_seed(SEED)
    halo = torch.randint(0, 256, (rk.HALO,), dtype=torch.uint8,
                         generator=gen)
    words = torch.zeros(cfg.nwords, dtype=torch.int32)
    nrounds = idev._nrounds_for_depth(0xFFFF, cfg)
    packed, seg_out, sto, halo, words = (
        x.to(dev) for x in (packed, seg_out, sto, halo, words))
    out = torch.full((out_pad,), OUT_SENTINEL, dtype=torch.uint8, device=dev)
    scratch = torch.full((used + (1 << 16),), LINK_SENTINEL,
                         dtype=torch.int32, device=dev)
    launched = ctypes.c_int(0)
    rc = rk._lib().zt_lz_resolve(
        packed.data_ptr(), packed.stride(0), packed.shape[1], k,
        seg_out.data_ptr(), words.data_ptr(), words.shape[0],
        sto.data_ptr(), sto.shape[1], halo.data_ptr(), used, out_pad,
        nrounds, out.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0,
        ctypes.byref(launched))
    n = rk.HALO + used
    want = watch.plain_of(packed, seg_out, words, sto, halo, used, nrounds,
                          cfg)[:n]
    line = {"used": used, "hops_per_round": rk.hops_per_round(used),
            "lanes": lanes + 3, "nrounds": nrounds, "rc": rc,
            "launches": launched.value,
            "launches_expected": rk.launches_per_tile(nrounds, used),
            "differing_bytes": int((out[:n] != want).sum()),
            "tile_is_the_literal_run": bool(
                (out[rk.HALO:n] == 0x41).all()),
            "out_past_used_overwritten": int(
                (out[n:] != OUT_SENTINEL).sum()),
            "scratch_past_used_overwritten": int(
                (scratch[used:] != LINK_SENTINEL).sum())}
    check(rc == 0 and line["launches"] == line["launches_expected"]
          and line["differing_bytes"] == 0
          and line["tile_is_the_literal_run"]
          and line["out_past_used_overwritten"] == 0
          and line["scratch_past_used_overwritten"] == 0, line)
    return line


def k6_bounds(idev, watch, dev) -> dict:
    """K6's bounds on both of its round shapes (`_k6_corrupt`): a corrupt
    CFG_S tile of 1,000 bytes (7 hops a round, a byte a thread), and a
    corrupt tile of CFG_L's shape and 300,000 bytes, past SMALL_TILE (3
    hops a round, 8 bytes a thread); each over several expansion CTAs."""
    return {"small": _k6_corrupt(idev, watch, dev, idev.CFG_S, 1000),
            "large": _k6_corrupt(idev, watch, dev, idev.CFG_L, 300_000)}


def decode_phase(dev, data: bytes, gz6: bytes, zl1: bytes, zl9: bytes,
                 watch: ResolveWatch, tables_watch: TablesWatch):
    """Phase 5, the decode path. Returns (the run's kernel launches, K4's,
    K6's and K9's rows for the kernel line, the 64 MiB gzip stream's decode
    seconds)."""
    from zippy_tpu_torch import api, common, gzip_format
    from zippy_tpu_torch.ops import checksums as tc
    from zippy_tpu_torch.ops import inflate_device as idev
    from zippy_tpu_torch.ops import inflate_kernels as ik
    from zippy_tpu_torch.ops import kernel_build as kb

    rk = watch.rk

    small = data[:ZLIB_BYTES]
    half = ZLIB_BYTES // 2
    two = gzip.compress(small[:half], 6) + gzip.compress(small[half:], 6)
    streams = (
        ("gzip L6 64 MiB (compress phase)", gz6, data, "gzip"),
        ("zlib L1 8 MiB (compress phase)", zl1, small, "zlib"),
        ("zlib L9 8 MiB (compress phase)", zl9, small, "zlib"),
        ("zlib L6 64 MiB (CPython)", zlib.compress(data, 6), data, "zlib"),
        ("zlib L0 8 MiB stored (CPython)", zlib.compress(small, 0), small,
         "zlib"),
        ("gzip two members 8 MiB (CPython)", two, small, "gzip"))
    torch.cuda.synchronize()
    for key in kb.LAUNCHES:
        kb.LAUNCHES[key] = 0
    runs = []
    for label, blob, want, fmt in streams:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = api.uncompress(blob)
        sec = time.perf_counter() - t0
        runs.append({"phase": "decode", "run": label, "bytes": len(want),
                     "compressed_bytes": len(blob), "seconds": sec,
                     "MB_per_s": len(want) / sec / 1e6,
                     "peak_device_GiB": torch.cuda.max_memory_allocated()
                     / 2**30, "equal_input": out == want})
        check(out == want, label)
    launches = dict(kb.LAUNCHES)
    check(all(launches[k] > 0 for k in DECODE_KERNELS)
          and launches["huffman_tables"] == 0
          and launches["match_tokens"] == 0
          and launches["pack_tokens"] == 0
          and launches["join_rows"] == 0, launches)

    # Outside the counted run: the scan alone, the decode given its index
    # (twice) and CPython's decompress, per stream.
    all_indexes = {}
    for run, (label, blob, want, fmt) in zip(runs, streams):
        t0 = time.perf_counter()
        indexes = _member_indexes(idev, gzip_format, blob, fmt)
        run["scan_s"] = time.perf_counter() - t0
        run["tiles"] = sum(len(idev._plan_tiles(
            index, idev._pick_cfg(index["total_out"])))
            for _, index in indexes)
        run["k4_launches"] = sum(_k4_launches(idev, index)
                                 for _, index in indexes)
        run["k6_launches"] = sum(_k6_launches(idev, rk, index)
                                 for _, index in indexes)
        given = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = _decode_given(idev, gzip_format, blob, fmt, indexes)
            given.append(time.perf_counter() - t0)
            check(out == want, label + " given its index")
        run["decode_given_index_s"] = given
        t0 = time.perf_counter()
        back = gzip.decompress(blob) if fmt == "gzip" else zlib.decompress(
            blob)
        run["cpython_decompress_s"] = time.perf_counter() - t0
        check(back == want, label + " CPython")
        all_indexes[label] = indexes
        emit(run)
    # K4 and K9 run once per batch that has a busy lane, not once per
    # tile; K6 launches_per_tile times a tile.
    batches = sum(run["k4_launches"] for run in runs)
    k6_want = sum(run["k6_launches"] for run in runs)
    emit({"phase": "decode_launches", **launches,
          "tiles": sum(run["tiles"] for run in runs),
          "k4_batches_with_busy_lanes": batches,
          "lz_resolve_expected": k6_want,
          "lz_resolve_plain_cuda_calls": watch.plain_cuda_calls,
          "block_tables_plain_cuda_calls": tables_watch.plain_cuda_calls})
    check(launches["inflate_extract"] == batches
          and launches["block_tables"] == batches
          and launches["lz_resolve"] == k6_want
          and watch.plain_cuda_calls == 0
          and tables_watch.plain_cuda_calls == 0,
          (launches, batches, k6_want))

    # The 64 MiB gzip stream given its index: no host sync from the first
    # tile to the last, then the checksums and the bytes.
    pos, index = all_indexes[streams[0][0]][0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        buf, keep = idev._run_tiles(gz6, index, dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    tpos = (index["end_bit"] + 7) // 8
    no_sync = {"phase": "decode_no_sync", "run": streams[0][0],
               "adler_equal_scan": tc.adler32_device(buf) == index["adler"],
               "crc_equal_trailer": tc.crc32_device(buf)
               == int.from_bytes(gz6[tpos:tpos + 4], "little"),
               "equal_input": buf.cpu().numpy().tobytes() == data}
    del buf, keep
    emit(no_sync)
    check(all(v for k, v in no_sync.items() if k not in ("phase", "run")),
          no_sync)

    # The same stream in batches of 8 tiles: one K4 and one K9 launch per
    # batch.
    cap, idev._TILES_PER_LAUNCH = idev._TILES_PER_LAUNCH, 8
    before = dict(kb.LAUNCHES)
    try:
        out = api.uncompress(gz6)
        capped = {"phase": "decode_batch_cap", "run": streams[0][0],
                  "tiles_per_launch": idev._TILES_PER_LAUNCH,
                  "k4_launches": kb.LAUNCHES["inflate_extract"]
                  - before["inflate_extract"],
                  "k9_launches": kb.LAUNCHES["block_tables"]
                  - before["block_tables"],
                  "k4_batches_with_busy_lanes": _k4_launches(idev, index),
                  "equal_input": out == data}
    finally:
        idev._TILES_PER_LAUNCH = cap
    emit(capped)
    check(capped["equal_input"] and capped["k4_launches"]
          == capped["k4_batches_with_busy_lanes"] == capped["k9_launches"],
          capped)

    bad = bytearray(two)
    bad[-5] ^= 0xFF
    try:
        api.uncompress(bytes(bad))
        flipped = False
    except common.ZippyError:
        flipped = True
    emit({"phase": "decode_flipped_crc", "raises_ZippyError": flipped})
    check(flipped, "a flipped crc decoded")

    stages: dict = {}
    t0 = time.perf_counter()
    out = idev.inflate_device(gz6, start_bit=gzip_format.parse_header(gz6)[
        "data_offset"] * 8, stages=stages)
    emit({"phase": "decode_stages", "run": streams[0][0] + ", raw stream",
          "seconds": time.perf_counter() - t0,
          **{k + "_s": v for k, v in stages.items()}})
    check(out == data, "staged decode")
    emit({"phase": "trace", "run": "decode given its index, "
          + streams[0][0], **device_trace(
              lambda: idev.inflate_device_array(gz6, index))})
    # One tile from its uploaded pack, as bench_torch_device.py's
    # device_inflate_tile rows decode it: K9, K4 and K6's launches.
    cfg = idev._pick_cfg(index["total_out"])
    tile = idev._plan_tiles(index, cfg)[0]
    keep: list = []
    packs = idev._upload_packs([idev._tile_pack(
        gz6, index, tile, cfg, idev._nrounds_for_depth(tile.depth, cfg))],
        dev, keep)
    halo = torch.zeros(idev.HALO, dtype=torch.uint8, device=dev)
    emit({"phase": "trace", "run": "one-tile decode, " + streams[0][0],
          **device_trace(lambda: idev._decode_tile(
              packs[0], halo, tile, k=int(index["every"]), cfg=cfg))})
    del packs, keep

    row = k4_phase(idev, ik, streams, all_indexes, dev)
    row["launches"] = launches["inflate_extract"]

    # K6 against its plain version on every tile and K9 on every batch of
    # the six streams, each decoded given its index; then K6 on the 64 MiB
    # stream's first tile.
    lines, k9_lines = [], []
    for label, blob, want, fmt in streams:
        with watch.checking(label) as line, \
                tables_watch.checking(label) as k9_line:
            out = _decode_given(idev, gzip_format, blob, fmt,
                                all_indexes[label])
        lines.append(line)
        k9_lines.append(k9_line)
        check(out == want and watch.good(line)
              and TablesWatch.good(k9_line, batches=False), (line, k9_line))
    tile = k6_tile(idev, ik, watch, streams[0][0], gz6,
                   all_indexes[streams[0][0]][0][1], dev)
    emit({"phase": "lz_resolve_streams", "streams": lines, "tile": tile,
          "corrupt_tile": k6_bounds(idev, watch, dev)})
    k6 = {"name": "lz_resolve", "route": "cuda",
          "source": "zippy_tpu_torch/csrc/resolve.cu",
          "replaces": "zippy_tpu/ops/inflate_device.py:359",
          "launches": launches["lz_resolve"],
          "max_abs_err": max(line["max_abs_err"] for line in lines),
          **{key: tile[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "share_of_bound",
                                        "hops_per_round")},
          "library_ms": None}
    k9 = block_tables_phase(idev, tables_watch, gz6, index, k9_lines, dev)
    k9["launches"] = launches["block_tables"]
    torch.cuda.empty_cache()
    return launches, row, k6, k9, runs[0]["seconds"]


def block_tables_phase(idev, tables_watch, blob: bytes, index, lines: list,
                       dev) -> dict:
    """K9 against its plain version on corrupt records, the lines of the
    decodes it was checked on beside; then one launch over the first batch
    of `index`'s decode (its records as the decode passes them, a view into
    the packed buffers) timed, with its bound and the launch floor. Returns
    K9's row for the kernel line (launches filled in by the caller)."""
    corrupt = {}
    for kind, lens8 in corrupt_lens8(dev).items():
        corrupt[kind] = tables_watch.new_line(kind)
        tables_watch.compare(lens8, corrupt[kind])
    cfg = idev._pick_cfg(index["total_out"])
    batch = _batches(idev, idev._plan_tiles(index, cfg))[0]
    keep: list = []
    packs = idev._upload_packs(
        [idev._tile_pack(blob, index, t, cfg,
                         idev._nrounds_for_depth(t.depth, cfg))
         for t in batch], dev, keep)
    lens8 = idev._unpack(packs, cfg)[4]
    rows = lens8.shape[0] * lens8.shape[1]
    floor_ms = launch_floor_ms(dev)
    bound_ms, bound_by = bound(tables_work(rows))
    ms = kernel_ms(lambda: tables_watch.wrapper(lens8), 100)
    line = {"phase": "block_tables", "streams": lines, "corrupt": corrupt,
            "batch_tiles": len(batch), "batch_rows": rows, "ms": ms,
            "plain_ms": call_ms(lambda: tables_watch.plain(
                lens8.reshape(-1, 318)), 3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "launch_floor_ms": floor_ms,
            "traced": device_trace(lambda: tables_watch.wrapper(lens8))}
    emit(line)
    checked = lines + list(corrupt.values())
    check(all(TablesWatch.good(ln, batches=False) for ln in checked)
          and sum(ln["batches"] for ln in lines) > 0
          and all(ln["batches"] for ln in corrupt.values()), line)
    del packs, keep
    return {"name": "block_tables", "route": "cuda",
            "source": "zippy_tpu_torch/csrc/inflate.cu",
            "replaces": "zippy_tpu/ops/inflate_device.py:176",
            "launches": None,
            "max_abs_err": max(ln["max_abs_err"] for ln in checked),
            "ms": ms, "plain_ms": line["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "rows": rows,
            "launch_floor_ms": floor_ms,
            "launch_floor_multiple": ms / floor_ms}


INDEXED_MEMBERS = (1 << 20, 8 << 20)


def indexed_phase(dev, data: bytes, gz6: bytes, single_compress_s: float,
                  watch: ResolveWatch, tables_watch: TablesWatch):
    """Phase 6, the indexed serving format, at each of INDEXED_MEMBERS.
    Returns the kernel launches of its counted array=True decodes, K4's,
    K6's and K9's largest differences from their plain versions on their
    batches and tiles, and K6 on the first tile of each member size."""
    from zippy_tpu_torch import api, common
    from zippy_tpu_torch import gzip_format as gf
    from zippy_tpu_torch.ops import inflate_device as idev
    from zippy_tpu_torch.ops import inflate_kernels as ik
    from zippy_tpu_torch.ops import kernel_build as kb

    # The scanned decode of phase 4's single-member stream and CPython's,
    # timed here beside the indexed decodes.
    t0 = time.perf_counter()
    check(api.uncompress(gz6) == data, "scanned uncompress")
    scanned_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(gzip.decompress(gz6) == data, "CPython")
    cpython_s = time.perf_counter() - t0

    # Every scan and every member decode of the runs below is counted; the
    # member decodes keep the index each was given.
    scan, dispatch = idev.build_decode_index, idev._dispatch
    scans, given = [0], []

    def counted_scan(*args, **kwargs):
        scans[0] += 1
        return scan(*args, **kwargs)

    def kept_dispatch(data, index, *args, **kwargs):
        given.append(index)
        return dispatch(data, index, *args, **kwargs)

    def no_sync_dispatch(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    total, k4_err, k6_err, k6_tiles = dict.fromkeys(kb.LAUNCHES, 0), 0, 0, []
    k9_err = 0
    for member_size in INDEXED_MEMBERS:
        label = f"{member_size >> 20} MiB members"
        torch.cuda.synchronize()
        for key in kb.LAUNCHES:
            kb.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        blob = gf.compress_device_indexed(data, 6, member_size=member_size)
        compress_s = time.perf_counter() - t0
        # One K5 and one K8 launch a group of each member's encode, and
        # K7's.
        compress_k5 = kb.LAUNCHES["huffman_tables"]
        compress_k7 = kb.LAUNCHES["match_tokens"]
        compress_k8 = kb.LAUNCHES["pack_tokens"]
        compress_k10 = kb.LAUNCHES["join_rows"]
        total["huffman_tables"] += compress_k5
        total["match_tokens"] += compress_k7
        total["pack_tokens"] += compress_k8
        total["join_rows"] += compress_k10
        want_k5, want_k7 = (sum(
            encode_launches(min(member_size, len(data) - i), 6)[key]
            for i in range(0, len(data), member_size))
            for key in ("huffman_tables", "match_tokens"))
        spans = gf._zt_spans(blob)
        check(spans is not None, label + ": the ZT lengths do not chain")
        members = [(n, gf._member_zx(blob, pos) is not None)
                   for pos, n in spans]
        sidecar_bytes = sum(n for n, side in members if side)
        t0 = time.perf_counter()
        check(gzip.decompress(blob) == data, label + " CPython")
        line = {"phase": "indexed", "run": label, "bytes": len(data),
                "compressed_bytes": len(blob),
                "data_members": sum(not side for _, side in members),
                "sidecar_members": sum(side for _, side in members),
                "sidecar_share": sidecar_bytes / len(blob),
                "compress_s": compress_s,
                "compress_huffman_tables_launches": compress_k5,
                "compress_huffman_tables_expected": want_k5,
                "compress_match_tokens_launches": compress_k7,
                "compress_match_tokens_expected": want_k7,
                "compress_pack_tokens_launches": compress_k8,
                "single_member_compress_s": single_compress_s,
                "cpython_decompress_s": time.perf_counter() - t0,
                "scanned_uncompress_s": scanned_s,
                "scanned_cpython_decompress_s": cpython_s}
        idev.build_decode_index = counted_scan
        idev._dispatch = kept_dispatch
        try:
            for name, fn in (
                    ("uncompress_device_bytes",
                     lambda: gf.uncompress_device(blob)),
                    ("uncompress_device_array",
                     lambda: gf.uncompress_device(blob, array=True)),
                    ("uncompress", lambda: api.uncompress(blob))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                line[name + "_s"] = time.perf_counter() - t0
                if name.endswith("array"):
                    check(all(buf.shape == (n,) for buf, n in out), name)
                    out = b"".join(buf.cpu().numpy().tobytes()
                                   for buf, _ in out)
                line[name + "_equal_input"] = out == data
                check(out == data, f"{label} {name}")
            line["scan_calls"] = scans[0]
            check(scans[0] == 0, f"{label}: {scans[0]} scans")

            # One array=True decode counted: one K1 and one K2 + K3 per
            # non-empty member, K4 and K9 once per batch with a busy lane.
            given.clear()
            torch.cuda.synchronize()
            for key in kb.LAUNCHES:
                kb.LAUNCHES[key] = 0
            gf.uncompress_device(blob, array=True)
            launches = dict(kb.LAUNCHES)
        finally:
            idev.build_decode_index = scan
            idev._dispatch = dispatch
        busy = sum(int(index["total_out"]) > 0 for index in given)
        want = {"adler_chunks": busy, "crc_rows": busy, "crc_combine": busy,
                "inflate_extract": sum(_k4_launches(idev, index)
                                       for index in given),
                "block_tables": sum(_k4_launches(idev, index)
                                    for index in given),
                "huffman_tables": 0, "match_tokens": 0, "pack_tokens": 0,
                "join_rows": 0,
                "lz_resolve": sum(_k6_launches(idev, watch.rk, index)
                                  for index in given)}
        line["launches"] = launches
        line["launches_expected"] = want
        for key in total:
            total[key] += launches[key]
        check(launches == want and compress_k5 == want_k5
              and compress_k7 == want_k7 and compress_k8 == want_k5
              and compress_k10 == want_k5
              and all(launches[k] for k in DECODE_KERNELS), line)

        # K4 against its plain version on every batch of that decode, at
        # the tile size its members took.
        k4_line, _ = k4_against_plain(idev, ik, label, blob,
                                      [(None, index) for index in given], dev)
        line["inflate_extract_vs_plain"] = k4_line
        k4_err = max(k4_err, k4_line["max_abs_err"])
        check(k4_line["equal_plain"], line)
        # K6 against its plain version on every tile and K9 on every batch
        # of the same decode, and K6 on the first member's first tile
        # timed.
        with watch.checking(label) as k6_line, \
                tables_watch.checking(label) as k9_line:
            parts = gf.uncompress_device(blob, array=True)
        line["lz_resolve_vs_plain"] = k6_line
        line["block_tables_vs_plain"] = k9_line
        k6_err = max(k6_err, k6_line["max_abs_err"])
        k9_err = max(k9_err, k9_line["max_abs_err"])
        check(b"".join(buf.cpu().numpy().tobytes() for buf, _ in parts)
              == data and watch.good(k6_line)
              and TablesWatch.good(k9_line), line)
        del parts
        k6_tiles.append(k6_tile(idev, ik, watch, label, blob, given[0], dev))
        del given[:]

        # The same stream decoded the other way: every data member scanned,
        # then the members decoded given their indexes.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        indexes = [(pos, scan(blob, gf.parse_header(blob, pos)[
            "data_offset"] * 8)) for pos, _ in gf.member_indexes(blob)]
        line["scanned_members_scan_s"] = time.perf_counter() - t0
        out = gf.uncompress_gzip_device_all(blob, indexes=indexes)
        line["scanned_members_s"] = time.perf_counter() - t0
        check(out == data, label + " scanned members")
        del indexes, out

        # Every member dispatched with no host sync, then the one fetch.
        torch.cuda.synchronize()
        idev._dispatch = no_sync_dispatch
        try:
            parts = gf.uncompress_device(blob, array=True)
        finally:
            idev._dispatch = dispatch
        line["no_sync_dispatch_members"] = len(parts)
        line["no_sync_equal_input"] = b"".join(
            buf.cpu().numpy().tobytes() for buf, _ in parts) == data
        del parts
        check(line["no_sync_equal_input"], label + " no-sync dispatch")

        # A flipped crc in the second data member's trailer.
        second = [i for i, (_, side) in enumerate(members) if not side][1]
        end = sum(n for n, _ in members[:second + 1])
        bad = bytearray(blob)
        bad[end - 5] ^= 0xFF
        raised = []
        for array in (False, True):
            try:
                gf.uncompress_device(bytes(bad), array=array)
                raised.append(False)
            except common.ZippyError:
                raised.append(True)
        line["flipped_crc_raises_ZippyError"] = raised
        # A flipped byte in the middle of that member's body: its sidecar
        # index still cuts the tiles, so K4 and K6 decode garbage, which
        # the crc32 gate refuses; then the intact stream still decodes.
        bad = bytearray(blob)
        bad[end - 8 - members[second][0] // 2] ^= 0xFF
        try:
            gf.uncompress_device(bytes(bad), array=True)
            raised.append(False)
        except common.ZippyError:
            raised.append(True)
        line["flipped_body_raises_ZippyError"] = raised[-1]
        line["after_flips_equal_input"] = b"".join(
            buf.cpu().numpy().tobytes()
            for buf, _ in gf.uncompress_device(blob, array=True)) == data
        emit(line)
        check(all(raised) and line["after_flips_equal_input"], line)
        del blob, bad
        torch.cuda.empty_cache()
    emit({"phase": "lz_resolve_tiles", "tiles": k6_tiles})
    return total, k4_err, k6_err, k9_err, k6_tiles


RANK_WORKER = r"""
import json, sys, time
import torch
from zippy_tpu_torch.parallel import distributed

rank, coord, scratch, backend = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                 sys.argv[4])
shard = open(f"{scratch}/shard{rank}", "rb").read()
distributed.initialize(coord, 2, rank, backend=backend)
# gloo: both ranks on cuda:0; NCCL: the default, the rank's own card.
devices = [torch.device("cuda", 0)] if backend == "gloo" else None
t0 = time.perf_counter()
stream = distributed.compress_gzip_all_hosts(shard, 6, devices=devices)
sec = time.perf_counter() - t0
open(f"{scratch}/stream{rank}", "wb").write(stream)
print(json.dumps({"rank": rank, "backend": torch.distributed.get_backend(),
                  "seconds": sec, "stream_bytes": len(stream),
                  "current_device": torch.cuda.current_device()}))
torch.distributed.destroy_process_group()
"""

FRESH_WORKER = r"""
import json, os, sys, time
import torch
scratch = sys.argv[1]
t0 = time.perf_counter()
torch.zeros(1, device="cuda")
context_s = time.perf_counter() - t0
import zippy_tpu_torch as zt
t0 = time.perf_counter()
calls = zt.warmup()
cold_s = time.perf_counter() - t0
t0 = time.perf_counter()
zt.warmup()
warm_s = time.perf_counter() - t0
# This process's first profiler session, taken once.
body = open(f"{scratch}/body", "rb").read()
t0 = time.perf_counter()
with zt.profiling.trace(f"{scratch}/trace"):
    with zt.profiling.annotate("chip_smoke decode"):
        out = zt.uncompress(body, zt.dfDeflate)
trace_s = time.perf_counter() - t0
(name,) = os.listdir(f"{scratch}/trace")
text = open(f"{scratch}/trace/{name}").read()
print(json.dumps({"calls": calls, "cold_s": cold_s, "warm_s": warm_s,
                  "cuda_context_s": context_s, "traced_decode_s": trace_s,
                  "traced_decode_bytes": len(out),
                  "trace_bytes": len(text),
                  "names_inflate_extract_kernel":
                      "inflate_extract_kernel" in text,
                  "names_annotation": "chip_smoke decode" in text,
                  "current_device": torch.cuda.current_device()}))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(argvs: list, timeout: int) -> list:
    """Run one `python -c` process per argv at once from the repo root;
    return (returncode, stdout, stderr) of each, killing any still running
    at the timeout."""
    procs = [subprocess.Popen([sys.executable, "-c", *argv], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def multi_host(data: bytes, backend: str) -> dict:
    """Two ranks on `backend`, each compressing its own 4 MiB shard with
    compress_gzip_all_hosts at level 6 (a fresh port on a lost bind race);
    both streams read back here and decoded."""
    from zippy_tpu_torch.parallel import distributed

    shards = [data[:4 << 20], data[4 << 20:8 << 20]]
    for rank, shard in enumerate(shards):
        (SCRATCH / f"shard{rank}").write_bytes(shard)
    for attempt in range(3):
        coord = f"localhost:{_free_port()}"
        results = _run_workers([[RANK_WORKER, str(rank), coord, str(SCRATCH),
                                 backend] for rank in range(2)], 600)
        if all(rc == 0 for rc, _, _ in results):
            break
        raced = any("Address already in use" in err for _, _, err in results)
        if not (raced and attempt < 2):
            break
    for rc, _, err in results:
        check(rc == 0, f"rank failed: {err[-2000:]}")
    streams = [(SCRATCH / f"stream{rank}").read_bytes() for rank in range(2)]
    want = shards[0] + shards[1]
    t0 = time.perf_counter()
    back = distributed.uncompress_gzip_all_hosts(streams[0])
    line = {"ranks": [json.loads(out.strip().splitlines()[-1])
                      for _, out, _ in results],
            "same_stream_on_both_ranks": streams[0] == streams[1],
            "cpython_equal_concatenation": gzip.decompress(streams[0]) == want,
            "uncompress_gzip_all_hosts_s": time.perf_counter() - t0,
            "uncompress_gzip_all_hosts_equal": back == want}
    check(line["same_stream_on_both_ranks"]
          and line["cpython_equal_concatenation"]
          and line["uncompress_gzip_all_hosts_equal"]
          and all(r["current_device"] == 0 and r["backend"] == backend
                  for r in line["ranks"]), line)
    return line


def share_kernels_vs_plain(ck, x: torch.Tensor) -> int:
    """K1 on a share's padded chunks, K2 on its rows and tail, and K3 on
    their CRCs, each against its plain version: the largest difference."""
    n = x.shape[0]
    nch = -(-n // ck.CHUNK)
    chunks = torch.zeros(nch * ck.CHUNK, dtype=torch.uint8, device=x.device)
    chunks[:n] = x
    chunks = chunks.view(nch, ck.CHUNK)
    full = n // ck.CRC_ROW_BYTES
    rows = x[:full * ck.CRC_ROW_BYTES].view(full, ck.CRC_ROW_BYTES)
    tail = x[full * ck.CRC_ROW_BYTES:]
    crcs = ck.crc_rows(rows, tail)
    last = n - full * ck.CRC_ROW_BYTES or ck.CRC_ROW_BYTES
    pairs = list(zip(ck.adler_chunks(chunks), ck.adler_chunks_plain(chunks)))
    pairs += [(crcs, ck.crc_rows_plain(rows, tail)),
              (ck.crc_combine(crcs, last), ck.crc_combine_plain(crcs, last))]
    return max(int((a.long() - b.long()).abs().max()) for a, b in pairs)


def parallel_phase(dev, data: bytes, gz6: bytes, watch: ResolveWatch,
                   tables_watch: TablesWatch) -> tuple[dict, list]:
    """Phase 8, the multi-device layers. Returns the kernel launches of its
    counted run and the largest differences of K1-K3, of K4, of K6 and of
    K9 from their plain versions on the shares and the devices= decode's
    tiles and batches ([k1-k3, k4, k6, k9])."""
    from zippy_tpu_torch import gzip_format, parallel
    from zippy_tpu_torch.ops import checksum_kernels as ck
    from zippy_tpu_torch.ops import inflate_device as idev
    from zippy_tpu_torch.ops import inflate_kernels as ik
    from zippy_tpu_torch.ops import kernel_build as kb

    SCRATCH.mkdir(parents=True, exist_ok=True)
    current = torch.cuda.current_device()

    def nshares(n: int, devs: list) -> int:
        """The checksums' non-empty shares: of whole 1 MiB rows."""
        return min(len(devs), -(-n // (1 << 20)))

    def same_device(what: str) -> None:
        check(torch.cuda.current_device() == current,
              f"{what} changed the current device")

    lists = {"default_devices": parallel.default_devices(),
             "cuda:0 x2": [torch.device("cuda", 0)] * 2}
    body = gz6[gzip_format.parse_header(gz6)["data_offset"]:-8]
    small = data[:ZLIB_BYTES]
    big = np.random.default_rng(SEED).integers(
        0, 256, BIG_BYTES, dtype=np.uint8).tobytes()
    torch.cuda.synchronize()
    for key in kb.LAUNCHES:
        kb.LAUNCHES[key] = 0
    want = dict.fromkeys(kb.LAUNCHES, 0)

    # Encode: every list's stream equals the single-device body.
    for name, devs in lists.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = parallel.deflate_sharded(data, 6, devs)
        line = {"phase": "parallel", "run": f"deflate_sharded L6 64 MiB, "
                f"{name}", "devices": [str(d) for d in devs],
                "seconds": time.perf_counter() - t0,
                "peak_device_GiB": torch.cuda.max_memory_allocated() / 2**30,
                "compressed_bytes": len(got),
                "equal_single_device_body": got == body}
        emit(line)
        check(line["equal_single_device_body"], line)
        same_device("deflate_sharded")
        for key, count in encode_launches(len(data), 6, len(devs)).items():
            want[key] += count
    two = lists["cuda:0 x2"]

    # Containers on 8 MiB over two shares.
    line = {"phase": "parallel", "run": "containers 8 MiB, cuda:0 x2"}
    for fmt, fn, level, back in (
            ("gzip", parallel.compress_gzip_sharded, 1, gzip.decompress),
            ("zlib", parallel.compress_zlib_sharded, 9, zlib.decompress)):
        t0 = time.perf_counter()
        blob = fn(small, level, two)
        line[f"{fmt}_L{level}_seconds"] = time.perf_counter() - t0
        line[f"{fmt}_L{level}_ratio"] = len(blob) / len(small)
        line[f"{fmt}_L{level}_cpython_equal"] = back(blob) == small
        same_device(fmt)
        for key, count in encode_launches(len(small), level,
                                          len(two)).items():
            want[key] += count
    for key in ("crc_rows", "crc_combine", "adler_chunks"):
        want[key] += nshares(len(small), two)
    emit(line)
    check(all(v for k, v in line.items() if k.endswith("equal")), line)

    # Checksums: every list, three sizes, against zlib.
    sums = []
    for n, payload in ((0, b""), (MAIN_BYTES, data), (len(big), big)):
        for name, devs in lists.items():
            t0 = time.perf_counter()
            crc = parallel.crc32_sharded(payload, devs)
            crc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            adler = parallel.adler32_sharded(payload, devs)
            adler_s = time.perf_counter() - t0
            shares = nshares(n, devs)
            for key in ("crc_rows", "crc_combine", "adler_chunks"):
                want[key] += shares
            sums.append({"bytes": n, "devices": name, "shares": shares,
                         "crc32_s": crc_s, "adler32_s": adler_s,
                         "crc32_equal_zlib": crc == zlib.crc32(payload),
                         "adler32_equal_zlib": adler == zlib.adler32(payload)})
            same_device("checksums")
    emit({"phase": "parallel", "run": "checksums", "calls": sums})
    check(all(s["crc32_equal_zlib"] and s["adler32_equal_zlib"]
              for s in sums), sums)

    # Decode: the 64 MiB body given its index, in turns with no devices
    # (one K4 launch a batch) and over each list (one a share with lanes).
    index = idev.build_decode_index(body)
    cfg = idev._pick_cfg(index["total_out"])
    batch_lanes = [sum(t.s1 - t.s0 for t in batch)
                   for batch in _batches(idev, idev._plan_tiles(index, cfg))]
    decodes = {"devices=None": None, **lists}
    seconds = {name: [] for name in decodes}
    for _ in range(2):
        for name, devs in decodes.items():
            t0 = time.perf_counter()
            out = idev.inflate_device(body, index, devices=devs)
            seconds[name].append(time.perf_counter() - t0)
            check(out == data, f"decode over {name}")
            same_device("inflate_device")
            want["adler_chunks"] += 1
            want["inflate_extract"] += sum(min(len(devs or [dev]), lanes)
                                           for lanes in batch_lanes if lanes)
            want["block_tables"] += sum(1 for lanes in batch_lanes if lanes)
            want["lz_resolve"] += _k6_launches(idev, watch.rk, index)
    launches = dict(kb.LAUNCHES)
    line = {"phase": "parallel", "run": "decode 64 MiB body given its "
            "index", "seconds": seconds,
            "tiles": len(idev._plan_tiles(index, cfg)),
            "batches_with_busy_lanes": sum(1 for n in batch_lanes if n),
            "launches": launches, "launches_expected": want}
    emit(line)
    check(launches == want, line)

    # Outside the counted run: each kernel on each share of each list
    # against its plain version, and K4's shares against its one launch.
    k13_err = max(share_kernels_vs_plain(ck, x) for devs in lists.values()
                  for _, x in parallel.blocks._shares(
                      np.frombuffer(data, np.uint8), devs, 1 << 20))
    keep: list = []
    k4_err, equal, shares = 0, True, 0
    for _, _, _, words, seg, used, tables in _k4_inputs(idev, body, index,
                                                        dev, keep):
        if not sum(used):
            continue
        k = index["every"]
        whole = ik.inflate_extract(words, seg, used, tables, k)
        for devs in lists.values():
            parts = []
            for sdev, w, s, u, t in idev.lane_shares(words, seg, used,
                                                     tables, devs):
                got = ik.inflate_extract(w, s, u, t, k)
                plain = ik._extract_plain(w, s, u, t, k)
                equal &= bool(torch.equal(got, plain))
                k4_err = max(k4_err, int((got.long() - plain.long())
                                         .abs().max()))
                parts.append(got.to(dev))
                shares += 1
                same_device(f"K4 on {sdev}")
            equal &= bool(torch.equal(torch.cat(parts, dim=1), whole))
    del keep
    line = {"phase": "parallel", "run": "kernels on shares",
            "k4_shares": shares, "k1_k3_max_abs_err": k13_err,
            "k4_max_abs_err": k4_err,
            "k4_shares_equal_plain_and_one_launch": equal}
    emit(line)
    check(k13_err == 0 and k4_err == 0 and equal, line)

    # K6 against its plain version on every tile, and K9 on every batch, of
    # the decode over two shares on one card (the tables are built once a
    # batch on the first device, and the tokens come back to it, which
    # resolves).
    label = "decode 64 MiB body given its index, cuda:0 x2"
    with watch.checking(label) as line, \
            tables_watch.checking(label) as k9_line:
        out = idev.inflate_device(body, index, devices=two)
    emit({"phase": "parallel", "run": "lz_resolve against plain", **line})
    emit({"phase": "parallel", "run": "block_tables against plain",
          **k9_line})
    check(out == data and watch.good(line) and TablesWatch.good(k9_line),
          (line, k9_line))
    same_device("K6 after a devices= decode")
    k6_err = line["max_abs_err"]

    # Multi-host: two ranks on gloo and cuda:0; on a host with two cards
    # or more also on NCCL, each rank on its own card.
    emit({"phase": "parallel", "run": "compress_gzip_all_hosts, 2 ranks, "
          "gloo, cuda:0", **multi_host(data, "gloo")})
    if torch.cuda.device_count() >= 2:
        emit({"phase": "parallel", "run": "compress_gzip_all_hosts, 2 ranks, "
              "nccl, a card each", **multi_host(data, "nccl")})
    same_device("multi-host")

    # A fresh process (the libraries already built): warmup() twice, then
    # one trace of a decode of the 64 MiB body, its first profiler session,
    # taken once: it names K4's kernel and the annotation.
    (SCRATCH / "body").write_bytes(body)
    ((rc, out, err),) = _run_workers([[FRESH_WORKER, str(SCRATCH)]], 600)
    check(rc == 0, f"fresh process failed: {err[-2000:]}")
    line = {"phase": "parallel", "run": "warmup() and profiling.trace in a "
            "fresh process", **json.loads(out.strip().splitlines()[-1])}
    emit(line)
    check(line["current_device"] == current
          and line["calls"] == 3 * torch.cuda.device_count()
          and line["traced_decode_bytes"] == len(data)
          and line["names_inflate_extract_kernel"]
          and line["names_annotation"], line)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, [k13_err, k4_err, k6_err, k9_line["max_abs_err"]]


ARCHIVE_FILES = 1024
ARCHIVE_DIRS = 64
ARCHIVE_EMPTY = 8
ARCHIVE_MEDIAN = 16 << 10
ARCHIVE_SIGMA = 1.5
ARCHIVE_MAX = 8 << 20
TRACE_FILES = 128


def archive_tree(data: bytes) -> dict:
    """Phase 9's tree, {path: contents}: ARCHIVE_FILES files over
    ARCHIVE_DIRS directories whose sizes are log-normal (median
    ARCHIVE_MEDIAN, sigma ARCHIVE_SIGMA) clipped to [1, ARCHIVE_MAX] and
    scaled so that they hold len(data) bytes, cut from `data` at seeded
    offsets, except 1 file in 16 of random bytes (stored blocks); and
    ARCHIVE_EMPTY empty files. The shape of a zip of a source tree or a
    dataset shard."""
    rng = np.random.default_rng(SEED)
    sizes = rng.lognormal(np.log(ARCHIVE_MEDIAN), ARCHIVE_SIGMA,
                          ARCHIVE_FILES)
    for _ in range(20):
        sizes = np.clip(sizes * len(data) / sizes.sum(), 1, ARCHIVE_MAX)
    sizes = sizes.astype(np.int64)
    room = np.flatnonzero(sizes < ARCHIVE_MAX)
    sizes[room[np.argmax(sizes[room])]] += len(data) - sizes.sum()
    tree = {}
    for i, n in enumerate(sizes.tolist()):
        name = f"d{i % ARCHIVE_DIRS:02d}/f{i:04d}.bin"
        if i % 16 == 15:
            tree[name] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        else:
            off = int(rng.integers(0, len(data) - n + 1))
            tree[name] = data[off:off + n]
    for i in range(ARCHIVE_EMPTY):
        tree[f"d{i * ARCHIVE_DIRS // ARCHIVE_EMPTY:02d}/empty{i}.txt"] = b""
    return tree


def _zip_stream(blob: bytes, info) -> bytes:
    """An entry's stored bytes in a zip, from its local header."""
    pos = info.header_offset
    name_len, extra_len = struct.unpack_from("<HH", blob, pos + 26)
    start = pos + 30 + name_len + extra_len
    return blob[start:start + info.compress_size]


def _read_tree(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in root.rglob("*") if p.is_file()}


def archive_phase(dev, data: bytes, watch: ResolveWatch,
                  tables_watch: TablesWatch,
                  join_watch: JoinWatch) -> tuple[dict, int, int, int, int]:
    """Phase 9, the archive layer. Returns the kernel launches of its
    counted run and the largest differences of K1-K3, of K4, of K6 and of
    K9 from their plain versions on its sampled entries; K10's joins of
    the writer's runs of rows are held to its plain version here."""
    import io
    import tarfile
    import zipfile

    import zippy_tpu_torch as zt
    from zippy_tpu_torch import common, tarballs, ziparchives
    from zippy_tpu_torch.ops import checksum_kernels as ck
    from zippy_tpu_torch.ops import deflate_device as td
    from zippy_tpu_torch.ops import inflate_device as idev
    from zippy_tpu_torch.ops import inflate_kernels as ik
    from zippy_tpu_torch.ops import kernel_build as kb
    from zippy_tpu_torch.ops import match_kernels as mk

    root = SCRATCH / "archives"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    tree = archive_tree(data)
    build_s = time.perf_counter() - t0
    names = list(tree)
    nonempty = [n for n in names if tree[n]]
    payloads = [tree[n] for n in nonempty]
    total = sum(map(len, payloads))
    gmax = td._group_size(td._level_params(1)[0], td.BLOCK)
    rows = {h: sum(1 for _ in td._entry_rows(payloads, td.BLOCK, h))
            for h in (0, td.HIST)}
    groups = sum(-(-r // gmax) for r in rows.values())
    # K10 joins each payload's run of rows in a group: one launch a run.
    runs = 0
    for h in (0, td.HIST):
        owner = [p for p, _, _, _ in td._entry_rows(payloads, td.BLOCK, h)]
        runs += sum(len(set(owner[i:i + gmax]))
                    for i in range(0, len(owner), gmax))
    torch.cuda.synchronize()
    launches = dict.fromkeys(kb.LAUNCHES, 0)

    def counted(fn):
        """fn() with the launches counted from zero; returns (result,
        seconds, the step's launches) and adds them to the phase's."""
        torch.cuda.synchronize()
        for key in kb.LAUNCHES:
            kb.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        step_launches = dict(kb.LAUNCHES)
        for key in launches:
            launches[key] += step_launches[key]
        return out, sec, step_launches

    # Zip, current API: one batched encode of every entry.
    torch.cuda.reset_peak_memory_stats()
    blob, create_s, create_l = counted(lambda: zt.create_zip_archive(tree))
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        infos = {i.filename: i for i in zf.infolist()}
        zipfile_equal = (set(infos) == set(names)
                         and all(zf.read(n) == tree[n] for n in names))
    line = {"phase": "archives", "run": "create_zip_archive",
            "files": len(names), "empty_files": len(names) - len(nonempty),
            "bytes": total, "zip_bytes": len(blob),
            "ratio": len(blob) / total, "tree_build_s": build_s,
            "seconds": create_s, "MB_per_s": total / create_s / 1e6,
            "rows_one_block": rows[0], "rows_multi_block": rows[td.HIST],
            "rows_per_group": gmax, "groups": groups,
            "peak_device_GiB": torch.cuda.max_memory_allocated() / 2**30,
            "launches": create_l,
            "launches_expected": {"adler_chunks": 0,
                                  "crc_rows": len(nonempty),
                                  "crc_combine": len(nonempty),
                                  "inflate_extract": 0,
                                  "block_tables": 0,
                                  "huffman_tables": groups,
                                  "pack_tokens": groups,
                                  "join_rows": runs,
                                  "lz_resolve": 0,
                                  "match_tokens": groups
                                  * mk.launches_per_group(False)},
            "zipfile_equal": zipfile_equal}
    emit(line)
    check(zipfile_equal and create_l == line["launches_expected"], line)

    # The writer's joins against K10's plain version, on a second call
    # whose joins are kept (untimed): the random files' stored rows among
    # them, runs that continue a stream from the group before, and a
    # group's later runs, each at bit 0 of its own stream.
    kept_joins: list = []
    with join_watch.keeping(kept_joins):
        again = zt.create_zip_archive(tree)
    joins = join_watch.vs_plain(kept_joins)
    joins["continued_runs"] = sum(int(k[7] == 0 and bool(k[6][0].any()))
                                  for k in kept_joins)
    del kept_joins
    with zipfile.ZipFile(io.BytesIO(again)) as zf:
        joins["zipfile_equal"] = all(zf.read(n) == tree[n] for n in names)
    emit({"phase": "archives", "run": "create_zip_archive joins vs plain",
          "runs_expected": runs, **joins})
    check(JoinWatch.good(joins) and joins["groups"] == runs
          and joins["stored_rows"] > 0 and joins["continued_runs"] > 0
          and joins["zipfile_equal"], joins)

    # 16 sampled entries, each encoded alone: the smallest, multi-block
    # ones across the sizes (the largest included) and random ones.
    by_size = sorted(nonempty, key=lambda n: len(tree[n]))
    multi = [n for n in by_size if len(tree[n]) > td.BLOCK]
    rand = [n for n in nonempty if int(n[-8:-4]) % 16 == 15]
    sample = by_size[:4] + [multi[i * (len(multi) - 1) // 9]
                            for i in range(10)] + rand[:2]
    sample = list(dict.fromkeys(sample))
    per_entry = []
    for name in sample:
        t0 = time.perf_counter()
        alone = td.deflate(tree[name], 1)
        sec = time.perf_counter() - t0
        stream = _zip_stream(blob, infos[name])
        per_entry.append({"name": name, "bytes": len(tree[name]),
                          "blocks": -(-len(tree[name]) // td.BLOCK),
                          "stream_bytes": len(stream), "seconds": sec,
                          "equal_deflate_alone": stream == alone})
    mean_s = sum(e["seconds"] for e in per_entry) / len(per_entry)
    line = {"phase": "archives", "run": "per-entry sample",
            "entries": per_entry, "per_entry_mean_s": mean_s,
            "batched_s_per_entry": create_s / len(names),
            "per_entry_over_batched": mean_s / (create_s / len(names)),
            "per_entry_estimate_s": mean_s * len(nonempty),
            "random_entries_stored": [e["stream_bytes"] > e["bytes"]
                                      for e in per_entry
                                      if e["name"] in rand]}
    emit(line)
    check(all(e["equal_deflate_alone"] for e in per_entry)
          and any(line["random_entries_stored"]), line)

    # extract_all, extract_file and a flipped central-directory crc32.
    zpath = root / "tree.zip"
    zpath.write_bytes(blob)
    dest = root / "zip_out"
    _, extract_s, extract_l = counted(
        lambda: zt.extract_all_zip(zpath, dest))
    equal = _read_tree(dest) == tree
    shutil.rmtree(dest)
    deflated = [n for n in nonempty if infos[n].compress_type == 8]
    t0 = time.perf_counter()
    indexes = [idev.build_decode_index(_zip_stream(blob, infos[name]))
               for name in deflated]
    scan_s = time.perf_counter() - t0
    k6_want = sum(_k6_launches(idev, watch.rk, index) for index in indexes)
    del indexes
    big = max(nonempty, key=lambda n: len(tree[n]))

    def one_file():
        with zt.open_zip_archive(zpath) as reader:
            return reader.extract_file(big)
    got, file_s, file_l = counted(one_file)
    victim = sample[5]
    cd = blob.index(victim.encode(), blob.index(b"PK\x01\x02")) - 46
    bad = bytearray(blob)
    bad[cd + 16] ^= 0x01
    bad_path = root / "bad.zip"
    bad_path.write_bytes(bytes(bad))
    bad_dest = root / "bad_out"

    def flipped():
        try:
            zt.extract_all_zip(bad_path, bad_dest)
        except common.ZippyError:
            return True
        return False
    raised, flipped_s, _ = counted(flipped)
    line = {"phase": "archives", "run": "extract_all_zip",
            "seconds": extract_s, "MB_per_s": total / extract_s / 1e6,
            "equal_tree": equal, "scan_only_s": scan_s,
            "launches": extract_l,
            "launches_expected_k1_k3": len(nonempty),
            "launches_expected_lz_resolve": k6_want,
            "extract_file_bytes": len(tree[big]), "extract_file_s": file_s,
            "extract_file_equal": got == tree[big],
            "extract_file_launches": file_l,
            "flipped_cd_crc32_raises_ZippyError": raised,
            "flipped_s": flipped_s,
            "flipped_leaves_no_dest": not bad_dest.exists()}
    emit(line)
    check(equal and got == tree[big] and raised
          and line["flipped_leaves_no_dest"]
          and all(extract_l[k] == len(nonempty) for k in
                  ("adler_chunks", "crc_rows", "crc_combine"))
          and extract_l["inflate_extract"] > 0
          and extract_l["block_tables"] == extract_l["inflate_extract"]
          and extract_l["lz_resolve"] == k6_want
          and extract_l["huffman_tables"] == 0
          and extract_l["pack_tokens"] == 0
          and extract_l["match_tokens"] == 0, line)

    # The v1 ZipArchive and the v1 Tarball, from the tree on disk.
    src = root / "tree"
    for name, contents in tree.items():
        (src / name).parent.mkdir(parents=True, exist_ok=True)
        (src / name).write_bytes(contents)
    want = {f"tree/{k}": v for k, v in tree.items()}
    v1 = zt.ZipArchive()
    v1.add_dir(str(src))
    v1_path = root / "v1.zip"
    _, v1_write_s, v1_write_l = counted(
        lambda: v1.write_zip_archive(str(v1_path)))
    back = zt.ZipArchive()
    _, v1_open_s, v1_open_l = counted(lambda: back.open(v1_path))
    with zipfile.ZipFile(v1_path) as zf:
        v1_zipfile = {n: zf.read(n) for n in zf.namelist()
                      if not n.endswith("/")} == want
    line = {"phase": "archives", "run": "ZipArchive v1",
            "zip_bytes": v1_path.stat().st_size, "write_s": v1_write_s,
            "open_s": v1_open_s, "write_launches": v1_write_l,
            "open_launches": v1_open_l, "zipfile_equal": v1_zipfile,
            "open_equal": {k: e.contents for k, e in back.contents.items()
                           if e.kind == "file"} == want}
    emit(line)
    check(line["zipfile_equal"] and line["open_equal"], line)
    del v1, back

    tball = zt.Tarball()
    tball.add_dir(str(src))
    tgz = root / "tree.tgz"
    _, tgz_write_s, tgz_write_l = counted(
        lambda: tball.write_tarball(str(tgz)))
    with tarfile.open(tgz) as tf:
        tar_equal = {m.name: tf.extractfile(m).read() for m in tf
                     if m.isfile()} == want
    tar_dest = root / "tar_out"
    _, tgz_extract_s, tgz_extract_l = counted(
        lambda: tarballs.extract_all(tgz, tar_dest))
    line = {"phase": "archives", "run": "tgz (Tarball v1, L6)",
            "tgz_bytes": tgz.stat().st_size, "write_s": tgz_write_s,
            "write_MB_per_s": total / tgz_write_s / 1e6,
            "write_launches": tgz_write_l, "tarfile_equal": tar_equal,
            "extract_all_s": tgz_extract_s,
            "extract_MB_per_s": total / tgz_extract_s / 1e6,
            "extract_launches": tgz_extract_l,
            "extract_equal_tree": _read_tree(tar_dest / "tree") == tree}
    emit(line)
    check(tar_equal and line["extract_equal_tree"], line)
    del tball
    phase_launches = dict(launches)
    emit({"phase": "archives", "run": "launches", **phase_launches})
    check(all(v > 0 for v in phase_launches.values()), phase_launches)

    # Outside the counted run: the batched encode and the extract of the
    # tree's first TRACE_FILES files traced (device operations, the card's
    # idle share, the top kernels). The whole tree's traces hold about
    # 660,000 device events, whose processing took minutes.
    part = dict(list(tree.items())[:TRACE_FILES])
    part_zip = root / "part.zip"
    label = f"{len(part)} files, {sum(map(len, part.values()))} bytes"
    emit({"phase": "trace", "run": f"create_zip_archive, {label}",
          **device_trace(lambda: part_zip.write_bytes(
              zt.create_zip_archive(part)))})
    emit({"phase": "trace", "run": f"extract_all_zip, {label}",
          **device_trace(lambda: zt.extract_all_zip(part_zip,
                                                    root / "part_out"))})
    check(_read_tree(root / "part_out") == part, "traced extract")

    # K4 and K9 on every batch and K6 on every tile of 8 sampled entries'
    # decodes and K1-K3 on 8 entries, against their plain versions.
    k4_lines, k4_err, k6_lines, k9_lines = [], 0, [], []
    for name in [n for n in sample if n not in rand][-8:]:
        stream = _zip_stream(blob, infos[name])
        index = idev.build_decode_index(stream)
        k4_line, _ = k4_against_plain(idev, ik, name, stream,
                                      [(None, index)], dev)
        k4_lines.append(k4_line)
        k4_err = max(k4_err, k4_line["max_abs_err"])
        with watch.checking(name) as k6_line, \
                tables_watch.checking(name) as k9_line:
            out = idev.inflate_device(stream, index)
        k6_lines.append(k6_line)
        k9_lines.append(k9_line)
        check(out == tree[name] and watch.good(k6_line)
              and TablesWatch.good(k9_line), (k6_line, k9_line))
    k6_err = max(ln["max_abs_err"] for ln in k6_lines)
    k13_err = max(share_kernels_vs_plain(ck, torch.from_numpy(
        np.frombuffer(tree[n], np.uint8).copy()).to(dev))
        for n in sample[-8:])
    line = {"phase": "archives", "run": "kernels against plain",
            "k4_entries": [{k: v for k, v in ln.items()
                            if k in ("run", "tiles", "batches", "busy_lanes",
                                     "equal_plain", "max_abs_err")}
                           for ln in k4_lines],
            "k4_max_abs_err": k4_err, "k1_k3_entries": len(sample[-8:]),
            "k1_k3_max_abs_err": k13_err, "k6_entries": k6_lines,
            "k9_entries": k9_lines}
    emit(line)
    check(k4_err == 0 and k13_err == 0
          and all(ln["equal_plain"] and ln["batches"] for ln in k4_lines),
          line)
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return (phase_launches, k13_err, k4_err, k6_err,
            max(ln["max_abs_err"] for ln in k9_lines))


def driver_hooks_phase(dev) -> tuple[dict, int, int]:
    """Phase 10, the driver hooks (zippy_tpu_torch.entry). Returns the
    kernel launches of its counted run and the largest differences of K1-K3
    and of K4 from their plain versions on its dry runs' data and streams."""
    from zippy_tpu_torch import entry as ze
    from zippy_tpu_torch.ops import checksum_kernels as ck
    from zippy_tpu_torch.ops import deflate_device as td
    from zippy_tpu_torch.ops import inflate_device as idev
    from zippy_tpu_torch.ops import inflate_kernels as ik
    from zippy_tpu_torch.ops import kernel_build as kb
    from zippy_tpu_torch.ops import match_kernels as mk
    from zippy_tpu_torch.parallel import default_devices

    torch.cuda.synchronize()
    for key in kb.LAUNCHES:
        kb.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    step, args = ze.entry("cuda")
    got = step(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_launches = dict(kb.LAUNCHES)
    cpu_step, cpu_args = ze.entry("cpu")
    t0 = time.perf_counter()
    want = cpu_step(*cpu_args)
    cpu_s = time.perf_counter() - t0
    # The packed block behind a final fixed-Huffman block header.
    out = td._ByteBitAppender()
    td._append_block(out, "fixed", None, got[0].cpu().numpy().astype(
        np.uint32), int(got[1]), None, 0, True)
    block = args[0][:td.BLOCK].cpu().numpy().tobytes()
    line = {"phase": "driver_hooks", "run": "entry step, 64 KiB block",
            "seconds": step_s, "cpu_seconds": cpu_s,
            "total_bits": int(got[1]),
            "equal_cpu": [torch.equal(a.cpu(), b)
                          for a, b in zip(got, want)],
            "zlib_decodes_block": zlib.decompress(bytes(out.out), -15)
            == block, "launches": step_launches}
    emit(line)
    # The fixed-code step builds no Huffman tables, finds its tokens with
    # K7, once, and packs them with K8, once.
    check(all(line["equal_cpu"]) and line["zlib_decodes_block"]
          and step_launches["huffman_tables"] == 0
          and step_launches["pack_tokens"] == 1
          and step_launches["join_rows"] == 0
          and step_launches["match_tokens"] == mk.launches_per_group(False),
          line)

    runs = [("cuda:0 x2", 2, ["cuda:0"] * 2)]
    if torch.cuda.device_count() >= 2:
        n = len(default_devices())
        runs.append(("default_devices()", n, None))
    # The step's K7 and K8 launches count here too.
    streams, want_k5, want_k7 = [], 0, mk.launches_per_group(False)
    want_k8, want_k10 = 1, 0
    for label, n, devices in runs:
        t0 = time.perf_counter()
        data, blob = ze.dryrun_multichip(n, devices)
        emit({"phase": "driver_hooks", "run": f"dryrun_multichip({n}), "
              f"{label}", "seconds": time.perf_counter() - t0,
              "bytes": len(data), "stream_bytes": len(blob)})
        streams.append((label, data, blob))
        # Its encode over the n devices and over the first one, 2 KiB
        # blocks.
        for shares in (n, 1):
            counts = encode_launches(len(data), 6, shares, 2048)
            want_k5 += counts["huffman_tables"]
            want_k7 += counts["match_tokens"]
            want_k8 += counts["pack_tokens"]
            want_k10 += counts["join_rows"]
    torch.cuda.synchronize()
    launches = dict(kb.LAUNCHES)
    emit({"phase": "driver_hooks", "run": "launches", **launches,
          "huffman_tables_expected": want_k5,
          "match_tokens_expected": want_k7,
          "pack_tokens_expected": want_k8,
          "join_rows_expected": want_k10})
    # The decode's adler32 gate (K1), its tables (K9), its extraction (K4,
    # a share) and its resolution (K6).
    check(launches["adler_chunks"] > 0 and launches["inflate_extract"] > 0
          and launches["block_tables"] > 0 and launches["lz_resolve"] > 0
          and launches["huffman_tables"] == want_k5
          and launches["pack_tokens"] == want_k8
          and launches["join_rows"] == want_k10
          and launches["match_tokens"] == want_k7, launches)

    k4_lines, k4_err, k13_err = [], 0, 0
    for label, data, blob in streams:
        k4_line, _ = k4_against_plain(idev, ik, label, blob, [
            (None, idev.build_decode_index(blob))], dev)
        k4_lines.append(k4_line)
        k4_err = max(k4_err, k4_line["max_abs_err"])
        k13_err = max(k13_err, share_kernels_vs_plain(ck, torch.from_numpy(
            np.frombuffer(data, np.uint8).copy()).to(dev)))
    line = {"phase": "driver_hooks", "run": "kernels against plain",
            "k4": k4_lines, "k4_max_abs_err": k4_err,
            "k1_k3_max_abs_err": k13_err}
    emit(line)
    check(k4_err == 0 and k13_err == 0
          and all(ln["equal_plain"] and ln["batches"] for ln in k4_lines),
          line)
    return launches, k13_err, k4_err


def _cpu_model() -> str:
    """The host CPU's model name, family and model, from /proc/cpuinfo (a
    virtual machine may report its name as "unknown")."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if not key.strip():
                    break
                info[key.strip()] = value.strip()
    except OSError:
        pass
    return (f"{info.get('model name', 'unknown')} (family "
            f"{info.get('cpu family', '?')}, model {info.get('model', '?')})")


def phase4_digests(blobs: dict) -> dict:
    """The SHA-256 of the raw DEFLATE body of each of phase 4's streams, by
    label (a gzip member's FNAME padding is random; its body is not)."""
    out = {}
    for label, blob in blobs.items():
        if label.startswith("gzip"):
            start = 10 + (blob.index(b"\0", 10) + 1 - 10 if blob[3] & 8
                          else 0)
            body = blob[start:-8]
        else:
            body = blob[2:-4]
        out[label] = hashlib.sha256(body).hexdigest()
    return out


def host_engine_phase(data: bytes, phase4: dict, card_compress_s: float,
                      card_decode_s: float) -> dict:
    """Phase 11, the host engine (zippy_tpu_torch.native), on phase 4's
    payload and streams (`phase4`, by label). Returns the kernel launches
    of its counted run, the card's decodes of the host engine's streams;
    the host engine's own calls must launch none."""
    from zippy_tpu_torch import api, common, gzip_format
    from zippy_tpu_torch.common import ZippyError
    from zippy_tpu_torch.ops import kernel_build as kb

    # A cold build of the host engine, timed apart from phase 2's.
    SCRATCH.mkdir(parents=True, exist_ok=True)
    out = SCRATCH / "zippy_native.so"
    t0 = time.perf_counter()
    proc = subprocess.run(kb._command(kb.CSRC / "zippy_native.cpp", out),
                          capture_output=True, text=True, timeout=600)
    build_s = time.perf_counter() - t0
    out.unlink(missing_ok=True)
    emit({"phase": "host_engine", "run": "build", "seconds": build_s,
          "rc": proc.returncode, "flags": list(kb.HOST_FLAGS),
          "cpu": _cpu_model(), "nproc": os.cpu_count()})
    check(proc.returncode == 0, proc.stdout + proc.stderr)

    def timed(fn, reps: int = 2):
        secs, result = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            result = fn()
            secs.append(time.perf_counter() - t0)
        return result, secs

    small = data[:ZLIB_BYTES]
    torch.cuda.synchronize()
    for key in kb.LAUNCHES:
        kb.LAUNCHES[key] = 0
    streams = {}
    for level in (-2, -1, 0, 1, 6, 9):
        blob, secs = timed(lambda: api.compress(small, level,
                                                engine_name="native"))
        streams[level] = blob
        ok = gzip.decompress(blob) == small
        emit({"phase": "host_engine", "run": f"compress gzip L{level} "
              f"{len(small) >> 20} MiB", "seconds": secs, "MB_per_s": len(small) / min(secs)
              / 1e6, "ratio": len(blob) / len(small),
              "cpython_decodes": ok})
        check(ok, f"host engine L{level}")
    rows = {}
    for level in (1, 6):
        blob, secs = timed(lambda: api.compress(data, level,
                                                engine_name="native"))
        check(gzip.decompress(blob) == data, f"host engine L{level}")
        rows[f"compress L{level}"] = (secs, len(blob))
        streams[f"L{level} whole payload"] = blob
    gz6 = phase4["gzip L6 host bytes"]
    for label, blob in (("card's gzip L6", gz6),
                        ("own gzip L6", streams["L6 whole payload"])):
        out, secs = timed(lambda: api.uncompress(blob, engine_name="native"))
        check(out == data, f"host engine decode of the {label}")
        out, gsecs = timed(lambda: gzip_format.uncompress_gzip(blob))
        check(out == data, f"uncompress_gzip of the {label}")
        rows[f"decode {label}"] = (secs, len(blob))
        rows[f"uncompress_gzip {label}"] = (gsecs, len(blob))
    host_launches = dict(kb.LAUNCHES)
    for name, (secs, nbytes) in rows.items():
        emit({"phase": "host_engine",
              "run": f"{len(data) >> 20} MiB {name}", "seconds": secs, "MB_per_s": len(data) / min(secs) / 1e6,
              "stream_bytes": nbytes})
    emit({"phase": "host_engine", "run": "beside the card",
          "card_compress_gzip_L6_s": card_compress_s,
          "host_compress_gzip_L6_s": min(rows["compress L6"][0]),
          "card_decode_gzip_L6_s": card_decode_s,
          "host_decode_gzip_L6_s": min(rows["decode card's gzip L6"][0]),
          "card": card_line(), "cpu": _cpu_model(),
          "nproc": os.cpu_count(), "host_engine_launches": host_launches})
    check(not any(host_launches.values()), host_launches)

    # The card decodes the host engine's streams; a flipped crc raises on
    # both engines.
    torch.cuda.synchronize()
    for key in kb.LAUNCHES:
        kb.LAUNCHES[key] = 0
    for level, blob in streams.items():
        want = small if isinstance(level, int) else data
        check(api.uncompress(blob, engine_name="device") == want,
              f"the card's decode of the host engine's {level}")
    bad = bytearray(streams[6])
    bad[-8] ^= 0xFF
    raised = {}
    for name in ("native", "device"):
        try:
            api.uncompress(bytes(bad), engine_name=name)
            raised[name] = False
        except ZippyError:
            raised[name] = True
    launches = dict(kb.LAUNCHES)
    emit({"phase": "host_engine", "run": "card decodes", "launches":
          launches, "flipped_crc_raises": raised})
    check(all(raised.values()) and all(launches[k] > 0
                                       for k in DECODE_KERNELS), raised)
    emit({"phase": "host_engine", "run": "phase 4 stream digests",
          "raw_body_sha256": phase4_digests(phase4)})
    shutil.rmtree(SCRATCH, ignore_errors=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from zippy_tpu_torch import api, common
    from zippy_tpu_torch.ops import checksum_kernels as ck
    from zippy_tpu_torch.ops import checksums as tc
    from zippy_tpu_torch.ops import deflate_device as td
    from zippy_tpu_torch.ops import huffman_kernels as hk
    from zippy_tpu_torch.ops import kernel_build as kb
    from zippy_tpu_torch.ops import inflate_device as idev
    from zippy_tpu_torch.ops import inflate_kernels as ik
    from zippy_tpu_torch.ops import join_kernels as jk
    from zippy_tpu_torch.ops import match_kernels as mk
    from zippy_tpu_torch.ops import pack_kernels as pk
    from zippy_tpu_torch.ops import resolve_kernels as rk

    dev = torch.device("cuda")
    watch = ResolveWatch(rk)
    k7_watch = MatchWatch(mk)
    k8_watch = PackWatch(pk)
    k10_watch = JoinWatch(jk)
    k9_watch = TablesWatch(ik)
    card = card_line()
    # Phase 1: the card.
    emit({"phase": "card", "nvidia_smi": card,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # Phase 2: every native library, the nvcc builds started together.
    t0 = time.perf_counter()
    libs = kb.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(lib.name for lib in libs.values()),
          "ptxas": {name: [line.strip() for line in libs[name].with_suffix(
              ".log").read_text().splitlines()
              if "entry function" in line or "registers" in line
              or "spill" in line]
              for name in kb.CUDA_SOURCES}})
    # Phase 3: K1, K2 and K3 against their plain versions and zlib.
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    sizes = [0, 1, 511, 512, 513, 1 << 20, (256 << 20) + 7]
    for n in sizes:
        x = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                          generator=gen)
        host = x.cpu().numpy().tobytes()
        nch = max(1, -(-n // ck.CHUNK))
        chunks = torch.zeros(nch * ck.CHUNK, dtype=torch.uint8, device=dev)
        chunks[:n] = x
        chunks = chunks.view(nch, ck.CHUNK)
        nr = max(1, -(-n // ck.CRC_ROW_BYTES))
        rows = torch.zeros(nr * ck.CRC_ROW_BYTES, dtype=torch.uint8,
                           device=dev)
        rows[nr * ck.CRC_ROW_BYTES - n:] = x
        rows = rows.view(nr, ck.CRC_ROW_BYTES)
        s, w = ck.adler_chunks(chunks)
        s0, w0 = ck.adler_chunks_plain(chunks)
        r, r0 = ck.crc_rows(rows), ck.crc_rows_plain(rows)
        full = n // ck.CRC_ROW_BYTES
        in_place = x[:full * ck.CRC_ROW_BYTES].view(full, ck.CRC_ROW_BYTES)
        tail = x[full * ck.CRC_ROW_BYTES:]
        rt = ck.crc_rows(in_place, tail)
        last = n - full * ck.CRC_ROW_BYTES or ck.CRC_ROW_BYTES
        adler, crc = tc.adler32_device(x), tc.crc32_device(x)
        row = {"phase": "kernels", "bytes": n,
               "adler_chunks_equal_plain": bool(torch.equal(s, s0)
                                                and torch.equal(w, w0)),
               "crc_rows_equal_plain": bool(torch.equal(r, r0)),
               "crc_rows_tail_equal_plain": bool(torch.equal(
                   rt, ck.crc_rows_plain(in_place, tail))),
               "crc_combine_equal_plain": n == 0 or bool(torch.equal(
                   ck.crc_combine(rt, last), ck.crc_combine_plain(rt, last))),
               "adler32_equal_zlib": adler == zlib.adler32(host),
               "crc32_equal_zlib": crc == zlib.crc32(host)}
        if n == sizes[-1]:
            zeros = torch.zeros_like(rows)
            for name, fn, plain, work in (
                    ("adler_chunks", lambda: ck.adler_chunks(chunks),
                     lambda: ck.adler_chunks_plain(chunks), adler_work(nch)),
                    ("crc_rows", lambda: ck.crc_rows(rows),
                     lambda: ck.crc_rows_plain(rows), crc_work(nr)),
                    ("crc_combine", lambda: ck.crc_combine(r),
                     lambda: ck.crc_combine_plain(r), combine_work(nr))):
                row[name + "_ms"] = kernel_ms(fn, 20)
                row[name + "_call_ms"] = call_ms(fn, 20)
                row[name + "_plain_ms"] = call_ms(plain, 2)
                row[name + "_bound_ms"], row[name + "_bound_by"] = bound(work)
            row["crc_rows_zero_rows_ms"] = kernel_ms(
                lambda: ck.crc_rows(zeros), 20)
            # One unaligned view: crc32_device reads it from an aligned copy.
            view = x[1:]
            row["unaligned_crc32_equal_zlib"] = (
                view.data_ptr() % 16 != 0
                and tc.crc32_device(view) == zlib.crc32(host[1:]))
            del zeros, view
        emit(row)
        check(all(v for k, v in row.items()
                  if k.endswith(("_plain", "_zlib"))), row)
        del x, chunks, rows, s, w, s0, w0, r, r0, in_place, tail, rt
    torch.cuda.empty_cache()
    combine_edges_phase(ck, dev, gen)

    # The whole crc32 call on a CUDA tensor: an aligned 64 MiB payload (no
    # tail), 256 MiB + 7 (a 7-byte tail row) and an unaligned 64 MiB view,
    # each checked against zlib.
    calls = []
    for n, skip in ((MAIN_BYTES, 0), ((256 << 20) + 7, 0), (MAIN_BYTES, 1)):
        x = torch.randint(0, 256, (n + skip,), dtype=torch.uint8, device=dev,
                          generator=gen)[skip:]
        line = crc32_call(tc, x, 20)
        line["equal_zlib"] = (tc.crc32_device(x)
                              == zlib.crc32(x.cpu().numpy().tobytes()))
        calls.append(line)
        del x
    emit({"phase": "crc32_call", "calls": calls})
    # K2, K3, the 4-byte copy; an unaligned view adds its aligned copy.
    check(all(c["equal_zlib"] and c["device_ops"] == (3 if c["aligned"]
                                                      else 4)
              for c in calls), calls)
    torch.cuda.empty_cache()

    # Phase 4: the main path.
    data = mixed_text(MAIN_BYTES, SEED)
    small = data[:ZLIB_BYTES]
    x_dev = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    # K5's, K7's, K8's and K10's inputs are kept as the encodes from host
    # bytes hand them to their wrappers (the cuda tensor's groups are the
    # same), for phase 4's checks.
    wrapper, k5_inputs, k7_inputs, k8_inputs = hk.huffman_tables, {}, {}, {}
    k10_inputs: dict = {}

    def keeping(label):
        def tables(ll, d, n):
            k5_inputs.setdefault(label, []).append(
                (ll.clone(), d.clone(), n.clone()))
            return wrapper(ll, d, n)
        return tables

    torch.cuda.synchronize()
    for key in kb.LAUNCHES:
        kb.LAUNCHES[key] = 0
    runs, blobs = [], {}
    for label, src, level, fmt, want in (
            ("gzip L6 host bytes", data, 6, common.dfGzip, data),
            ("gzip L6 cuda tensor", x_dev, 6, common.dfGzip, data),
            ("zlib L1 host bytes", small, 1, common.dfZlib, small),
            ("zlib L9 host bytes", small, 9, common.dfZlib, small)):
        torch.cuda.reset_peak_memory_stats()
        keep_k7 = keep_k8 = keep_k10 = contextlib.nullcontext()
        if isinstance(src, bytes):
            hk.huffman_tables = keeping(label)
            keep_k7 = k7_watch.keeping(k7_inputs.setdefault(label, []))
            keep_k8 = k8_watch.keeping(k8_inputs.setdefault(label, []))
            keep_k10 = k10_watch.keeping(k10_inputs.setdefault(label, []))
        t0 = time.perf_counter()
        try:
            with keep_k7, keep_k8, keep_k10:
                blob = api.compress(src, level, fmt)
        finally:
            hk.huffman_tables = wrapper
        sec = time.perf_counter() - t0
        back = (gzip.decompress(blob) if fmt is common.dfGzip
                else zlib.decompress(blob))
        runs.append({"phase": "main_path", "run": label, "bytes": len(want),
                     "seconds": sec, "MB_per_s": len(want) / sec / 1e6,
                     "ratio": len(blob) / len(want),
                     "peak_device_GiB": torch.cuda.max_memory_allocated()
                     / 2**30,
                     "roundtrip": back == want})
        emit(runs[-1])
        check(back == want, label)
        blobs[label] = blob
    compress_kernels = ("adler_chunks", "crc_rows", "crc_combine",
                        "huffman_tables", "match_tokens", "pack_tokens",
                        "join_rows")
    launches = {key: kb.LAUNCHES[key] for key in compress_kernels}
    # K5, K8 and K10 once a group and K7 launches_per_group times a group:
    # 64 MiB at L6 twice, 8 MiB at L1 and at L9.
    want = {key: sum(encode_launches(nbytes, level)[key]
                     for nbytes, level in ((MAIN_BYTES, 6), (MAIN_BYTES, 6),
                                           (ZLIB_BYTES, 1), (ZLIB_BYTES, 9)))
            for key in ("huffman_tables", "match_tokens", "pack_tokens",
                        "join_rows")}
    want_k5 = want["huffman_tables"]
    emit({"phase": "main_path_launches", **launches,
          "huffman_tables_expected": want_k5,
          "match_tokens_expected": want["match_tokens"],
          "pack_tokens_expected": want["pack_tokens"],
          "join_rows_expected": want["join_rows"],
          "huffman_tables_groups_kept": {k: len(v)
                                         for k, v in k5_inputs.items()},
          "match_tokens_groups_kept": {k: len(v)
                                       for k, v in k7_inputs.items()},
          "pack_tokens_groups_kept": {k: len(v)
                                      for k, v in k8_inputs.items()},
          "join_rows_groups_kept": {k: len(v)
                                    for k, v in k10_inputs.items()}})
    kept_groups = want_k5 - encode_groups(MAIN_BYTES, 6)
    check(all(v > 0 for v in launches.values())
          and launches["huffman_tables"] == want_k5
          and launches["match_tokens"] == want["match_tokens"]
          and launches["pack_tokens"] == want["pack_tokens"] == want_k5
          and launches["join_rows"] == want["join_rows"] == want_k5
          and sum(map(len, k5_inputs.values())) == kept_groups
          and sum(map(len, k7_inputs.values())) == kept_groups
          and sum(map(len, k8_inputs.values())) == kept_groups
          and sum(map(len, k10_inputs.values())) == kept_groups, launches)

    # K7 against its plain version on every group of those encodes and on
    # seeded rows at every level of MATCH_LEVELS; one group issued with no
    # host sync allowed; K7 on the first full group of the level-6 and the
    # level-1 encodes, its own launches and the sort apart.
    k7_lines = {label: k7_watch.vs_plain(inputs)
                for label, inputs in k7_inputs.items()}
    k7_lines.update(match_vs_plain_rows(k7_watch, td, dev))
    emit({"phase": "match_tokens_vs_plain", "runs": k7_lines})
    check(all(MatchWatch.good(line) for line in k7_lines.values()), k7_lines)
    k7_group = k7_inputs["gzip L6 host bytes"][0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = td._encode_group(*k7_group[:3], **k7_group[3])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    emit({"phase": "match_tokens_no_sync", "rows": k7_group[0].shape[0],
          "issued": sorted(res)})
    del res, k7_group
    # K7's sort stage against its plain version: the first L1, L6 and L9
    # groups, and the L6 and L9 groups' shapes all zeros (one hash bucket)
    # and with a 3-byte period.
    sort_groups = [k7_inputs[label][0] for label in (
        "zlib L1 host bytes", "gzip L6 host bytes", "zlib L9 host bytes")]
    for label in ("gzip L6 host bytes", "zlib L9 host bytes"):
        sort_groups += [group for _, group in match_edge_groups(
            k7_inputs[label][0])]
    sort_line = sort_vs_plain(mk, sort_groups)
    del sort_groups
    emit({"phase": "k7_sort_vs_plain", **sort_line})
    check(sort_line["groups"] == 7
          and sort_line["launches"] == sort_line["launches_expected"]
          and set(sort_line["differing_elements"]) == {
              "keys", "inv", "keys3", "inv3", "c3"}
          and not any(sort_line["differing_elements"].values()), sort_line)
    k7_groups = {f"L{level}": match_split(k7_watch, k7_inputs[label][0], 10)
                 for level, label in ((6, "gzip L6 host bytes"),
                                      (1, "zlib L1 host bytes"))}
    # The same L6 group's shape filled with zeros (every position a 258-byte
    # match, one hash bucket) and with a 3-byte period: K7 against its
    # plain version and timed, the cover's scans of fixed length whatever
    # the data.
    for edge, edge_group in match_edge_groups(
            k7_inputs["gzip L6 host bytes"][0]):
        line = k7_watch.vs_plain([edge_group])
        check(MatchWatch.good(line), {edge: line})
        k7_groups[f"L6 {edge}"] = {**match_split(k7_watch, edge_group, 10),
                                   "vs_plain": line}
    del edge_group
    emit({"phase": "match_tokens_groups", **k7_groups})
    # Every device operation of a find_tokens call is one of K7's.
    check(k7_groups["L6"]["rows"] == td._group_size(12, td.BLOCK)
          and k7_groups["L1"]["rows"] == td._group_size(2, td.BLOCK)
          and all(line["sort_ms"] == 0 and line["trace_device_ops_per_call"]
                  == line["k7_ops_per_call"] > 0
                  for line in k7_groups.values()), k7_groups)

    # K5 against its plain version on every group of those encodes and on
    # HUFFMAN_ROWS seeded rows, HUFFMAN_REPEATS times; then one K5 launch
    # and one plain build over the first full group of the 64 MiB level-6
    # encode, traced.
    k5_lines = {label: huffman_vs_plain(hk, td, inputs)
                for label, inputs in k5_inputs.items()}
    ll, d, n = (torch.from_numpy(a).to(dev)
                for a in huffman_rows(HUFFMAN_ROWS, SEED))
    k5_lines["seeded rows"] = huffman_vs_plain(hk, td, [(ll, d, n)],
                                               HUFFMAN_REPEATS)
    emit({"phase": "huffman_tables_vs_plain", "runs": k5_lines})
    check(all(line["equal_plain"] and line["max_abs_err"] == 0
              for line in k5_lines.values())
          and all(k5_lines["seeded rows"]["modes"]), k5_lines)
    del ll, d, n
    group = k5_inputs["gzip L6 host bytes"][0]
    g = group[0].shape[0]
    check(g == td._group_size(12, td.BLOCK), f"first L6 group of {g} rows")
    emit({"phase": "trace", "run": f"huffman_tables, K5 ({g} rows)",
          **device_trace(lambda: hk.huffman_tables(*group))})
    emit({"phase": "trace", "run": f"huffman_tables_plain ({g} rows)",
          **device_trace(lambda: td.huffman_tables_plain(*group))})

    # K8 against its plain version on every group of those encodes and on
    # the edge cases (pack_edge_inputs) at the first L6 group's shape; then
    # one K8 launch and one plain pack of that group traced.
    k8_lines = {label: k8_watch.vs_plain(inputs)
                for label, inputs in k8_inputs.items()}
    for kind, edge in pack_edge_inputs(k7_inputs["gzip L6 host bytes"][0],
                                       dev).items():
        k8_lines[kind] = k8_watch.vs_plain([edge])
    del edge
    emit({"phase": "pack_tokens_vs_plain", "runs": k8_lines})
    check(all(PackWatch.good(line) for line in k8_lines.values()), k8_lines)
    pack_group = k8_inputs["gzip L6 host bytes"][0]
    g8 = pack_group[1][0].shape[0]
    check(g8 == g, f"first L6 pack group of {g8} rows")
    emit({"phase": "trace", "run": f"pack_tokens, K8 ({g8} rows)",
          **device_trace(lambda: pk.pack_tokens(*pack_group[:1],
                                                *pack_group[1]))})
    emit({"phase": "trace", "run": f"pack_tokens_plain ({g8} rows)",
          **device_trace(lambda: k8_watch.plain(*pack_group[:1],
                                                *pack_group[1]))})

    # K10 against its plain version on every group of those encodes (the
    # piece's bytes up to its last bit and the state row); one K10 launch
    # over the first L6 group traced.
    k10_lines = {label: k10_watch.vs_plain(inputs)
                 for label, inputs in k10_inputs.items()}
    emit({"phase": "join_rows_vs_plain", "runs": k10_lines})
    check(all(JoinWatch.good(line) for line in k10_lines.values())
          and k10_lines["gzip L6 host bytes"]["groups"]
          == encode_groups(MAIN_BYTES, 6), k10_lines)
    join_group = k10_inputs["gzip L6 host bytes"][0]
    g10 = join_group[1].shape[0]
    check(g10 == g, f"first L6 join group of {g10} rows")
    emit({"phase": "trace", "run": f"join_rows, K10 ({g10} rows)",
          **device_trace(lambda: jk.join_rows(*join_group))})

    stages: dict = {}
    t0 = time.perf_counter()
    td.deflate_array(x_dev, 6, stages=stages)
    emit({"phase": "stages", "run": "deflate L6 64 MiB cuda tensor",
          "seconds": time.perf_counter() - t0,
          **{k + "_s": v for k, v in stages.items()}})

    # The same encode traced, no stage syncs, with its device operations a
    # group (K7's 10, K5, K8, the fetch's copies and the little around
    # them).
    traced = device_trace(lambda: td.deflate_array(x_dev, 6))
    groups6 = encode_groups(MAIN_BYTES, 6)
    emit({"phase": "trace", "run": "deflate L6 64 MiB cuda tensor",
          **traced, "groups": groups6,
          "device_ops_per_group": None if traced["device_ops"] is None
          else traced["device_ops"] / groups6})

    # Kernel numbers at the shapes the main path gave each kernel: K1 the
    # 8 MiB zlib trailer, K2 the 64 MiB gzip trailer's rows (in place, no
    # tail) and K3 their 131072 row CRCs.
    nch = ZLIB_BYTES // ck.CHUNK
    chunks = x_dev[:ZLIB_BYTES].view(nch, ck.CHUNK)
    nr = MAIN_BYTES // ck.CRC_ROW_BYTES
    rows = x_dev.view(nr, ck.CRC_ROW_BYTES)
    row_crcs = ck.crc_rows(rows)
    floor_ms = launch_floor_ms(dev)
    kernels, calls = [], {"launch_floor_ms": floor_ms}
    for name, replaces, fn, plain, work, err in (
            ("adler_chunks", "zippy_tpu/ops/pallas_checksums.py:32",
             lambda: ck.adler_chunks(chunks),
             lambda: ck.adler_chunks_plain(chunks), adler_work(nch),
             lambda: max(int((a.long() - b.long()).abs().max())
                         for a, b in zip(ck.adler_chunks(chunks),
                                         ck.adler_chunks_plain(chunks)))),
            ("crc_rows", "zippy_tpu/ops/pallas_checksums.py:139",
             lambda: ck.crc_rows(rows), lambda: ck.crc_rows_plain(rows),
             crc_work(nr),
             lambda: int((ck.crc_rows(rows).long()
                          - ck.crc_rows_plain(rows).long()).abs().max())),
            ("crc_combine", "zippy_tpu/ops/pallas_checksums.py:188",
             lambda: ck.crc_combine(row_crcs),
             lambda: ck.crc_combine_plain(row_crcs), combine_work(nr),
             lambda: int((ck.crc_combine(row_crcs).long()
                          - ck.crc_combine_plain(row_crcs).long())
                         .abs().max()))):
        bound_ms, bound_by = bound(work)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "zippy_tpu_torch/csrc/checksums.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err(), "ms": kernel_ms(fn, 100),
            "plain_ms": call_ms(plain, 3), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
        calls[name + "_call_ms"] = call_ms(fn, 100)
    kernels[-1]["launch_floor_ms"] = floor_ms  # K3: near the floor
    # K5 at the first full group of the 64 MiB level-6 encode: near the
    # floor too, which says more than its share of the bound.
    bound_ms, bound_by = bound(huffman_work(g))
    k5 = {"name": "huffman_tables", "route": "cuda",
          "source": "zippy_tpu_torch/csrc/huffman.cu",
          "replaces": "zippy_tpu/ops/deflate_device.py:464",
          "launches": launches["huffman_tables"],
          "max_abs_err": max(line["max_abs_err"]
                             for line in k5_lines.values()),
          "ms": kernel_ms(lambda: hk.huffman_tables(*group), 100),
          "plain_ms": call_ms(lambda: td.huffman_tables_plain(*group), 3),
          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
          "launch_floor_ms": floor_ms}
    k5["launch_floor_multiple"] = k5["ms"] / floor_ms
    calls["huffman_tables_call_ms"] = call_ms(
        lambda: hk.huffman_tables(*group), 100)
    # K7 at the first full group of the 64 MiB level-6 encode: its
    # launches' device ms, by stage; torch.sort of the group's keys as the
    # sort stage's yardstick ("library_ms"); the level-1 group's beside.
    g6, g1 = k7_groups["L6"], k7_groups["L1"]
    k7 = {"name": "match_tokens", "route": "cuda",
          "source": "zippy_tpu_torch/csrc/match.cu",
          "replaces": "zippy_tpu/ops/deflate_device.py:94",
          "launches": launches["match_tokens"],
          "max_abs_err": max(line["max_abs_err"]
                             for line in k7_lines.values()),
          "ms": g6["ms"], "ms_by_stage": g6.get("ms_by_stage"),
          "sort_ms": g6["sort_ms"], "plain_ms": g6["plain_ms"],
          "bound_ms": g6["bound_ms"], "bound_by": g6["bound_by"],
          "bound_share": g6.get("bound_share"),
          "library_ms": g6["library_ms"],
          "library_call": "torch.sort of the keys (the sort stage)",
          "launches_per_group": g6["launches_per_group"],
          "call_ms": g6["call_ms"],
          "L1": {key: g1.get(key) for key in (
              "rows", "ms", "ms_by_stage", "plain_ms", "library_ms",
              "bound_ms", "bound_share")}}
    calls["match_tokens_call_ms"] = g6["call_ms"]
    # K8 at the first full group of the 64 MiB level-6 encode: its bound
    # from the sectors its tokens touch, the interface's arrays' beside it.
    tok8, tables8 = pack_group
    tokens, matches = (int(tok8[key].sum()) for key in ("is_tok",
                                                        "is_match"))
    n_block = tok8["is_tok"].shape[1]
    bound_ms, bound_by = bound(pack_work(g8, n_block, tok8))
    interface_ms, interface_by = bound(pack_work(g8, n_block))
    k8 = {"name": "pack_tokens", "route": "cuda",
          "source": "zippy_tpu_torch/csrc/pack.cu",
          "replaces": "zippy_tpu/ops/deflate_device.py:361",
          "launches": launches["pack_tokens"],
          "max_abs_err": max(line["max_abs_err"]
                             for line in k8_lines.values()),
          "ms": kernel_ms(lambda: pk.pack_tokens(tok8, *tables8), 100),
          "plain_ms": call_ms(lambda: k8_watch.plain(tok8, *tables8), 3),
          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
          "rows": g8, "tokens": tokens, "matches": matches,
          "interface_bound_ms": interface_ms,
          "interface_bound_by": interface_by}
    k8["bound_share"] = bound_ms / k8["ms"]
    calls["pack_tokens_call_ms"] = call_ms(
        lambda: pk.pack_tokens(tok8, *tables8), 100)
    # K10 at the first full group of the 64 MiB level-6 encode; its plain
    # version on CPU copies (the only tensors it takes), on the card's host.
    _, want_row = k10_watch.run(join_group, True)
    bound_ms, bound_by = bound(join_work(want_row, join_group[0],
                                         join_group[1]))
    cpu_group = k10_watch.cpu(join_group)
    k10 = {"name": "join_rows", "route": "cuda",
           "source": "zippy_tpu_torch/csrc/join.cu",
           "replaces": "none: the host splice, _assemble_block",
           "launches": launches["join_rows"],
           "max_abs_err": max(line["max_abs_err"]
                              for line in k10_lines.values()),
           "ms": kernel_ms(lambda: jk.join_rows(*join_group), 100),
           "plain_ms": call_ms(lambda: k10_watch.plain(*cpu_group), 3),
           "plain_on": "the card's host CPU",
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "rows": g10, "stream_bytes": (int(want_row[jk.BITS]) + 7) // 8,
           "launch_floor_ms": floor_ms}
    k10["bound_share"] = bound_ms / k10["ms"]
    calls["join_rows_call_ms"] = call_ms(lambda: jk.join_rows(*join_group),
                                         100)
    emit({"phase": "kernel_calls", **calls})
    check(all(k["max_abs_err"] == 0 for k in kernels + [k5, k7, k8, k10])
          and k7["ms"] is not None, kernels)
    del x_dev, chunks, rows, row_crcs, k5_inputs, group, k7_inputs
    del k8_inputs, pack_group, tok8, tables8, k10_inputs, join_group
    del cpu_group
    torch.cuda.empty_cache()

    # Phase 5: the decode path.
    decode_launches, k4, k6, k9, decode_s = decode_phase(
        dev, data, blobs["gzip L6 host bytes"], blobs["zlib L1 host bytes"],
        blobs["zlib L9 host bytes"], watch, k9_watch)
    for row in kernels + [k8, k10]:
        row["launches"] += decode_launches[row["name"]]
    kernels += [k4, k6, k9]
    check(k4["max_abs_err"] == 0 and k6["max_abs_err"] == 0
          and k9["max_abs_err"] == 0, (k4, k6, k9))

    def add_phase(launches: dict, errs: dict) -> None:
        """A phase's counted launches into every kernel's row, and its
        largest differences from the plain versions (by kernel name) into
        the rows of the kernels it checked."""
        for row in kernels + [k5, k7, k8, k10]:
            row["launches"] += launches[row["name"]]
            if row["name"] in errs:
                row["max_abs_err"] = max(row["max_abs_err"],
                                         errs[row["name"]])

    def kernel_errs(k13_err: int, k4_err: int, k6_err: int | None = None,
                    k9_err: int | None = None) -> dict:
        errs = {"adler_chunks": k13_err, "crc_rows": k13_err,
                "crc_combine": k13_err, "inflate_extract": k4_err,
                "lz_resolve": k6_err, "block_tables": k9_err}
        return {k: v for k, v in errs.items() if v is not None}

    # Phase 6: the indexed serving format.
    indexed_launches, k4_err, k6_err, k9_err, k6_tiles = indexed_phase(
        dev, data, blobs["gzip L6 host bytes"], runs[0]["seconds"], watch,
        k9_watch)
    add_phase(indexed_launches, {"inflate_extract": k4_err,
                                 "lz_resolve": k6_err,
                                 "block_tables": k9_err})
    # K6 on the first tile of a 1 MiB member (CFG_S) beside the row's
    # CFG_L tile.
    k6_keys = ("tile_bytes", "used", "nrounds", "hops_per_round",
               "launches", "ms", "plain_ms", "bound_ms", "bound_by",
               "share_of_bound")
    k6["cfg_s_tile"] = {key: k6_tiles[0][key] for key in k6_keys}
    # And on a zip entry's tile: the archive tree's text entry nearest its
    # median size, deflated at BestSpeed as create_zip_archive does.
    entry = min((v for i, v in enumerate(archive_tree(data).values())
                 if i % 16 != 15 and v),
                key=lambda v: abs(len(v) - ARCHIVE_MEDIAN))
    small = td.deflate(entry, 1)
    small_tile = k6_tile(idev, ik, watch, "zip entry", small,
                         idev.build_decode_index(small), dev)
    emit({"phase": "lz_resolve_small_tile", **small_tile})
    k6["small_tile"] = {key: small_tile[key] for key in k6_keys}

    # Phase 7: CPU and CUDA bytes.
    piece = data[:256 << 10]
    same = {}
    for level in (1, 6, 9):
        a = td.deflate(piece, level, device="cpu")
        b = td.deflate(piece, level)
        same[str(level)] = a == b
        check(zlib.decompress(b, wbits=-15) == piece, f"raw L{level}")
        same[f"uncompress {level}"] = (
            api.uncompress(b, common.dfDeflate, device="cpu")
            == api.uncompress(b, common.dfDeflate) == piece)
    emit({"phase": "cpu_vs_cuda", "bytes": len(piece), "identical": same})
    check(all(same.values()), same)

    # Phase 8: the multi-device layers.
    parallel_launches, errs = parallel_phase(
        dev, data, blobs["gzip L6 host bytes"], watch, k9_watch)
    add_phase(parallel_launches, kernel_errs(*errs))

    # Phase 9: the archive layer.
    archive_launches, *errs = archive_phase(dev, data, watch, k9_watch,
                                            k10_watch)
    add_phase(archive_launches, kernel_errs(*errs))

    # Phase 10: the driver hooks.
    hook_launches, k13_err, k4_err = driver_hooks_phase(dev)
    add_phase(hook_launches, kernel_errs(k13_err, k4_err))

    # Phase 11: the host engine.
    add_phase(host_engine_phase(data, blobs, runs[0]["seconds"], decode_s),
              {})

    # No decode path ran K6's or K9's plain version on the card, and no
    # encode path K7's or K8's.
    for name, w in (("lz_resolve", watch), ("match_tokens", k7_watch),
                    ("pack_tokens", k8_watch), ("block_tables", k9_watch),
                    ("join_rows", k10_watch)):
        emit({"phase": f"{name}_plain", "cuda_calls": w.plain_cuda_calls})
        check(w.plain_cuda_calls == 0,
              f"{name}'s plain version ran on the card")

    emit({"kernels": kernels + [k5, k7, k8, k10]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

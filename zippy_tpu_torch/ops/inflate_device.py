"""DEFLATE decoder on the card: the port of zippy_tpu/ops/inflate_device.py.

The index-based tiled decode of the reference, on a CUDA card:

1. The host scan (`build_decode_index`, csrc/zippy_native.cpp) records a
   checkpoint every 32 tokens, each Huffman block's code lengths, the
   stored spans, and the adler32 of the serial decode.
2. The host planner (`_plan_tiles`) cuts the checkpoints into tiles of
   fixed capacity (output bytes, segments, blocks, stored spans, stream
   words, match bytes), and `_tile_pack` packs each tile into one buffer.
   The two capacity sets are the reference's, so every tile can be held
   against its `_decode_tile`.
3. On the card, per batch of up to _TILES_PER_LAUNCH tiles
   (`_decode_batch`): the packs uploaded as one pinned buffer without a
   host sync, the per-block comparison tables of every tile in one launch
   of kernel K9 `block_tables` (ops/inflate_kernels.py, beside its plain
   version `block_tables_plain`), token extraction of every busy lane in one
   launch of kernel K4 `inflate_extract` (ops/inflate_kernels.py), then per
   tile the LZ resolution (`_resolve`: kernel K6 `lz_resolve`,
   ops/resolve_kernels.py: the tokens and stored spans expanded, then
   rounds of several pointer-doubling hops over the match bytes, in
   1 + ceil(nrounds / 3) launches for a CFG_S tile and 1 + ceil(nrounds / 2)
   for a CFG_L one). Tiles chain through a 32 KiB halo of decoded bytes,
   device to device.
4. Every tile's bytes land in one output buffer, whose adler32 (kernel K1)
   must equal the scan's, and for gzip whose crc32 (K2 + K3) must equal the
   trailer: a corrupt stream that passes the scan cannot return silent
   garbage. The reference folds the checksums tile by tile
   (`_combine_checksums`, `_crc_shift_device`); one pass over the whole
   output gives the same values with fewer launches, so those two are not
   ported. `inflate_device_array_acc` leaves the sums asked for on the
   card, so the members of a stream dispatch back to back and verify with
   one fetch.

The reference's `mesh=` is `devices=` here (`lane_shares`): each batch's
busy lanes are split over a list of devices, K4 runs on each share, and the
tokens come back to the first device, which resolves as above. The
reference's `warmup` is `zippy_tpu_torch.warmup`. Every gather and scatter
of the reference that XLA would clamp or drop is clamped, or sent to one
spare trailing slot, here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import gzip_format, profiling
from ..common import ZippyError, resolve_device, resolve_devices
from . import checksums, inflate_kernels, resolve_kernels
from .inflate_scan import inflate_scan
from .resolve_kernels import HALO

# Tokens per segment: the extraction runs this many dependent steps per lane.
_EVERY = 32

# Tiles per K4 launch: their packs go up as one buffer, their tables are
# built together, and one launch extracts all their busy lanes. 32 CFG_L
# tiles hold about a million busy lanes, several times the card's threads.
_TILES_PER_LAUNCH = 32


class TileConfig(NamedTuple):
    """Fixed per-tile capacities."""

    tile_out: int   # decoded bytes per tile
    nseg: int       # segment lanes (each covers up to _EVERY tokens)
    nblk: int       # Huffman table slots
    nsto: int       # stored-span slots
    nwords: int     # compressed uint32 words visible to the tile
    ncmp: int       # compact match-byte slots (LZ resolve runs over these)


def _mk_cfg(tile_out: int, nseg: int, nblk: int, nsto: int) -> TileConfig:
    # Words: ~1.1x the output (DEFLATE rarely expands past ~1.03x; stored
    # spans read their bytes from the words too) + header slack. Compact
    # capacity tile_out/2: match-heavier tiles cut earlier on the scan's
    # per-segment match-byte counts.
    return TileConfig(tile_out, nseg, nblk, nsto,
                      (tile_out + tile_out // 8 + (1 << 16)) // 4,
                      tile_out // 2)


# S covers streams up to 2 MiB; L is the streaming tile. The planner cuts on
# whichever capacity fills first, so any stream fits.
CFG_S = _mk_cfg(1 << 18, 4096, 8, 64)
CFG_L = _mk_cfg(1 << 22, 65536, 64, 256)


# ---------------------------------------------------------------------------
# Decode tables
# ---------------------------------------------------------------------------


def _block_tables(lens8: torch.Tensor) -> torch.Tensor:
    """K4's tables from the scan's code-length records, (rows, 318) or
    (ntiles, nblk, 318) uint8: (rows, 382) int32, the litlen code's fc, off,
    E, then the distance code's. Kernel K9 on the card, the plain version
    on the CPU (ops/inflate_kernels.block_tables)."""
    return inflate_kernels.block_tables(lens8)


# ---------------------------------------------------------------------------
# LZ resolution
# ---------------------------------------------------------------------------


def _resolve(packed, seg_out, words, sto, halo, used: int, nrounds: int,
             cfg: TileConfig) -> torch.Tensor:
    """One tile's output bytes (HALO + tile_out,) uint8 from its tokens,
    its stored-span table `sto` and the halo: kernel K6 on the card, the
    plain version on the CPU (ops/resolve_kernels.lz_resolve).
    out[HALO:HALO + used] is the tile's bytes and out[used:used + HALO]
    the next halo."""
    return resolve_kernels.lz_resolve(packed, seg_out, words, sto, halo, used,
                                      nrounds, cfg)


# ---------------------------------------------------------------------------
# The tile
# ---------------------------------------------------------------------------


def _buf_size(cfg: TileConfig) -> int:
    """uint32 words in the single packed per-tile upload buffer."""
    return (2 + cfg.nwords + 4 * cfg.nseg + 3 * cfg.nsto
            + (318 * cfg.nblk + 3) // 4)


def _unpack(packs: torch.Tensor, cfg: TileConfig):
    """Views of a batch of packed int32 tile buffers (ntiles, _buf_size):
    words (ntiles, nwords), the segment rows bit, block, ntok
    (ntiles, 3, nseg), seg_out (ntiles, nseg), the stored-span table rows
    source byte, output position, length (ntiles, 3, nsto), and the code
    lengths (ntiles, nblk, 318) uint8."""
    off = 2
    words = packs[:, off:off + cfg.nwords]
    off += cfg.nwords
    seg = packs[:, off:off + 3 * cfg.nseg].unflatten(1, (3, cfg.nseg))
    off += 3 * cfg.nseg
    seg_out = packs[:, off:off + cfg.nseg]
    off += cfg.nseg
    sto = packs[:, off:off + 3 * cfg.nsto].unflatten(1, (3, cfg.nsto))
    off += 3 * cfg.nsto
    lens8 = packs[:, off:off + (318 * cfg.nblk + 3) // 4].view(torch.uint8)
    return (words, seg, seg_out, sto,
            lens8[:, :318 * cfg.nblk].unflatten(1, (cfg.nblk, 318)))


def lane_shares(words, seg, used, tables, devices) -> list:
    """Split a batch's busy lanes (tile after tile, as K4 packs them) into
    one contiguous range a device, balanced by lane count, and place each
    range's inputs on its device: (device, words, seg, used, tables) for
    each range with a lane. A range holds the rows of the tiles it touches;
    where it starts inside a tile, that tile's segment rows are shifted so
    that its lanes start at 0 (K4 decodes the first `used` lanes of each
    tile's rows). The ranges' K4 outputs, side by side in device order, are
    the batch's."""
    total = sum(used)
    starts = np.cumsum([0] + list(used))
    nblk = tables.shape[0] // words.shape[0]
    out = []
    for i, dev in enumerate(devices):
        a = total * i // len(devices)
        b = total * (i + 1) // len(devices)
        if a == b:
            continue
        t0 = int(np.searchsorted(starts, a, side="right")) - 1
        t1 = int(np.searchsorted(starts, b, side="left"))
        lo = a - int(starts[t0])
        share_used = [min(b, int(starts[t + 1])) - max(a, int(starts[t]))
                      for t in range(t0, t1)]
        share_seg = seg[t0:t1]
        if lo:
            share_seg = share_seg.clone()
            share_seg[0, :, :share_used[0]] = seg[t0, :, lo:lo + share_used[0]]
        out.append((dev, words[t0:t1].to(dev), share_seg.to(dev), share_used,
                    tables[t0 * nblk:t1 * nblk].to(dev)))
    return out


def _extract(words, seg, used, tables, k: int, devices=None):
    """K4 over a batch's busy lanes: one launch on the batch's device, or
    with `devices` one launch a device on its lane share, the outputs
    brought back to the batch's device in lane order."""
    if devices is None:
        return inflate_kernels.inflate_extract(words, seg, used, tables, k)
    parts = [inflate_kernels.inflate_extract(w, s, u, t, k)
             for _, w, s, u, t in lane_shares(words, seg, used, tables,
                                              devices)]
    return torch.cat([p.to(words.device) for p in parts], dim=1)


def _decode_batch(packs, halo, tiles, *, k: int, cfg: TileConfig,
                  stages=None, devices=None):
    """A batch of tiles: every tile's tables in one build, the extraction
    of all their busy lanes in one K4 launch (none when no lane is busy;
    with `devices`, one a device with a lane share, `_extract`), then each
    tile's LZ resolution in order (`_resolve`), the halo chained. `packs`
    is the tiles' packed buffers (ntiles, _buf_size) int32 on the card,
    `halo` the 32 KiB before the first tile, `tiles` their plan (`_Tile`:
    busy lanes s1 - s0, output bytes `used`, depth).
    Yields each tile's out uint8 (HALO + tile_out,): its `used` bytes are
    out[HALO:HALO + used], and out[used:used + HALO] is the next halo."""
    dev = packs.device
    words, seg, seg_out, sto, lens8 = _unpack(packs, cfg)
    lanes = [t.s1 - t.s0 for t in tiles]
    if any(lanes):
        with profiling.span("tables", stages, dev):
            tables = _block_tables(lens8)
        with profiling.span("extract", stages, dev):
            packed = _extract(words, seg, lanes, tables, k, devices)
    else:
        packed = torch.zeros(k, 0, dtype=torch.int32, device=dev)
    col = 0
    for i, tile in enumerate(tiles):
        with profiling.span("resolve", stages, dev):
            out = _resolve(packed[:, col:col + lanes[i]],
                           seg_out[i, :lanes[i]], words[i], sto[i], halo,
                           tile.used, _nrounds_for_depth(tile.depth, cfg),
                           cfg)
        col += lanes[i]
        halo = out[tile.used:tile.used + HALO]
        yield out


def _decode_tile(pack, halo, tile, *, k: int, cfg: TileConfig,
                 stages=None) -> torch.Tensor:
    """One tile, as a batch of one: `pack` its packed buffer (_buf_size,)
    int32 on the card. Returns its out, as `_decode_batch` yields it."""
    return next(_decode_batch(pack[None], halo, [tile], k=k, cfg=cfg,
                              stages=stages))


# ---------------------------------------------------------------------------
# Host planner: cut the index into fixed-capacity tiles
# ---------------------------------------------------------------------------


class _Tile(NamedTuple):
    base: int          # absolute output offset of the tile's first byte
    used: int          # decoded bytes this tile
    w0: int            # absolute word offset of the tile's stream window
    s0: int            # segment range [s0, s1)
    s1: int
    t0: int            # stored-span range [t0, t1)
    t1: int
    b0: int            # block-id range [b0, b1)
    b1: int
    depth: int         # max copy-nesting depth among the tile's segments


def _plan_tiles(index, cfg: TileConfig) -> list[_Tile]:
    """Greedy fixed-capacity tiling of the checkpoint list.

    Entities (segments + stored spans) partition [0, total_out) contiguously
    in stream order; every capacity is monotone along that order, so each
    tile's end is a searchsorted over prefix arrays."""
    seg = index["segments"]
    sto = index["stored"]
    sto = sto[sto[:, 2] > 0] if sto.shape[0] else sto  # len-0 spans: no output
    total = int(index["total_out"])
    end_bit = int(index["end_bit"])
    nseg, nsto = seg.shape[0], sto.shape[0]

    ent_out = np.concatenate([seg[:, 1], sto[:, 1]])
    order = np.argsort(ent_out, kind="stable")
    ent_out = ent_out[order]
    ent_is_seg = order < nseg
    ent_bit = np.concatenate([seg[:, 0], sto[:, 0] * 8])[order]
    n_e = ent_out.shape[0]
    if n_e == 0:
        return []
    ent_end_out = np.concatenate([ent_out[1:], [total]])
    ent_end_bit = np.concatenate([ent_bit[1:], [end_bit]])
    sto_end_bit = (sto[:, 0] + sto[:, 2]) * 8
    ent_end_bit = np.maximum(
        ent_end_bit,
        np.concatenate([np.zeros(nseg, np.int64), sto_end_bit])[order])
    # +3 words: the 64-bit window read touches words[i + 2] at the last bit.
    ent_word_end = (ent_end_bit + 31) // 32 + 3
    ent_blk = np.concatenate(
        [seg[:, 2], np.full(nsto, -1, np.int64)])[order]
    # Match-byte capacity: the scan's per-segment match-byte counts bound
    # each tile's compact slots.
    ent_match = np.concatenate([seg[:, 4], np.zeros(nsto, np.int64)])[order]
    cum_match = np.cumsum(ent_match)
    # Per-tile depth: each tile sizes its pointer-doubling trip count from
    # the deepest chain it contains. Stored entities contribute depth 0.
    ent_depth = np.concatenate([seg[:, 5], np.zeros(nsto, np.int64)])[order] \
        if seg.shape[1] > 5 else np.full(n_e, int(1) << 62, np.int64)
    cum_seg = np.cumsum(ent_is_seg)
    cum_sto = np.cumsum(~ent_is_seg)
    # Running max block id (block ids are nondecreasing over segments but
    # stored entities interleave with -1).
    blk_ffill = np.maximum.accumulate(ent_blk)

    tiles = []
    i = 0
    base = 0
    while i < n_e:
        w0 = int(ent_bit[i] // 32)
        lo = i + 1  # a single entity always fits (extent <= 8256 or 65535)
        j = np.searchsorted(ent_end_out, base + cfg.tile_out, side="right")
        j = min(j, np.searchsorted(
            cum_seg, (cum_seg[i] - ent_is_seg[i]) + cfg.nseg, side="right"))
        j = min(j, np.searchsorted(
            cum_sto, (cum_sto[i] - (not ent_is_seg[i])) + cfg.nsto,
            side="right"))
        j = int(min(j, np.searchsorted(
            ent_word_end, w0 + cfg.nwords, side="right")))
        j = int(min(j, np.searchsorted(
            cum_match, (cum_match[i] - ent_match[i]) + cfg.ncmp,
            side="right")))
        # Distinct blocks referenced so far: ids are contiguous nondecreasing.
        first_blk = int(ent_blk[i]) if ent_is_seg[i] else int(
            max(blk_ffill[i], 0))
        j = int(min(j, np.searchsorted(
            blk_ffill, first_blk + cfg.nblk - 1, side="right")))
        j = max(j, lo)
        s0 = int(cum_seg[i] - ent_is_seg[i])
        s1 = int(cum_seg[j - 1])
        t0 = int(cum_sto[i] - (not ent_is_seg[i]))
        t1 = int(cum_sto[j - 1])
        b1 = int(blk_ffill[j - 1]) + 1 if s1 > s0 else first_blk + 1
        used = int(ent_end_out[j - 1]) - base
        depth = int(ent_depth[i:j].max()) if j > i else 0
        tiles.append(_Tile(base, used, w0, s0, s1, t0, t1, first_blk, b1,
                           depth))
        base += used
        i = j
    return tiles


def _pick_cfg(total_out: int) -> TileConfig:
    return CFG_S if total_out <= 8 * CFG_S.tile_out else CFG_L


def _nrounds_for_depth(depth: int, cfg: TileConfig) -> int:
    """Pointer-doubling trip count for one tile: log2 of the deepest chain
    it contains; the halo bounds any chain inside one tile, so the cap is
    log2(tokens per tile)."""
    cap = int(np.ceil(np.log2(cfg.nseg * _EVERY)))
    if depth >= 0xFFFF:  # the scan's u16 depth saturated
        return cap
    return max(1, min(cap, int(np.ceil(np.log2(max(depth, 2))))))


def _tile_pack(data, index, tile: _Tile, cfg: TileConfig,
               nrounds: int) -> np.ndarray:
    """One packed uint32 buffer per tile (fixed size): scalars, stream
    words, segment/stored tables, byte-packed code lengths."""
    seg = index["segments"]
    sto = index["stored"]
    sto = sto[sto[:, 2] > 0] if sto.shape[0] else sto
    out_pad = HALO + cfg.tile_out

    buf = np.zeros(_buf_size(cfg), dtype=np.uint32)
    buf[0] = tile.used
    buf[1] = nrounds
    off = 2

    lo = tile.w0 * 4
    hi = min(len(data), lo + cfg.nwords * 4)
    raw = bytes(data[lo:hi])
    nw = len(raw) // 4
    buf[off : off + nw] = np.frombuffer(raw[: nw * 4], "<u4")
    if len(raw) % 4:
        tail = raw[nw * 4 :] + b"\x00" * (4 - len(raw) % 4)
        buf[off + nw] = np.frombuffer(tail, "<u4")[0]
    off += cfg.nwords

    sp = buf[off : off + 3 * cfg.nseg].reshape(3, cfg.nseg)
    off += 3 * cfg.nseg
    so = buf[off : off + cfg.nseg]
    so[:] = out_pad
    off += cfg.nseg
    ns = tile.s1 - tile.s0
    if ns:
        rows = seg[tile.s0 : tile.s1]
        sp[0, :ns] = rows[:, 0] - tile.w0 * 32
        sp[1, :ns] = rows[:, 2] - tile.b0
        sp[2, :ns] = rows[:, 3]
        so[:ns] = rows[:, 1] - tile.base + HALO

    st = buf[off : off + 3 * cfg.nsto].reshape(3, cfg.nsto)
    off += 3 * cfg.nsto
    st[1] = out_pad  # empty slots sort past every output byte
    nt = tile.t1 - tile.t0
    if nt:
        rows = sto[tile.t0 : tile.t1]
        st[0, :nt] = rows[:, 0] - tile.w0 * 4
        st[1, :nt] = rows[:, 1] - tile.base + HALO
        st[2, :nt] = rows[:, 2]

    nb = tile.b1 - tile.b0
    if nb and index["block_lens"].shape[0]:
        lens8 = np.zeros((318 * cfg.nblk + 3) // 4 * 4, np.uint8)
        flat = index["block_lens"][tile.b0 : tile.b1].reshape(-1)
        lens8[: flat.shape[0]] = flat
        buf[off:] = lens8.view("<u4")
    return buf


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def build_decode_index(data: bytes, start_bit: int = 0, every: int = _EVERY):
    """One-time host scan producing the device decode index for the raw
    DEFLATE stream at bit `start_bit` of `data` (any producer). The index
    carries the adler32 of the serial decode, which every device decode
    verifies its own output against."""
    return inflate_scan(data, start_bit, every)


def _upload_packs(packs: list, device: torch.device,
                  keep: list) -> torch.Tensor:
    """The tiles' packed buffers as the rows of one int32 tensor on
    `device`: a CUDA upload goes from one pinned buffer without a host
    sync; the pinned buffer is appended to `keep`, for the caller to hold
    until it next synchronizes."""
    cuda = device.type == "cuda"
    host = torch.empty(len(packs), packs[0].shape[0], dtype=torch.int32,
                       pin_memory=cuda)
    for row, pack in zip(host.numpy(), packs):
        row[:] = pack.view(np.int32)
    profiling.count("upload.bytes", host.nbytes)
    if not cuda:
        return host.to(device)
    keep.append(host)
    return host.to(device, non_blocking=True)


def _run_tiles(data, index, device: torch.device, stages=None, devices=None):
    """Dispatch every tile, in batches of up to _TILES_PER_LAUNCH, back to
    back with no host sync, into one output buffer on `device` (with
    `devices`, each batch's extraction split over them). Returns (buffer
    of total_out bytes, the pinned upload buffers to hold until the next
    sync)."""
    total = int(index["total_out"])
    cfg = _pick_cfg(total)
    k = int(index["every"])
    with profiling.span("plan_pack", stages, device):
        tiles = _plan_tiles(index, cfg)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    halo = torch.zeros(HALO, dtype=torch.uint8, device=device)
    keep: list = []
    for b in range(0, len(tiles), _TILES_PER_LAUNCH):
        batch = tiles[b:b + _TILES_PER_LAUNCH]
        with profiling.span("plan_pack", stages, device):
            packs = [_tile_pack(data, index, tile, cfg,
                                _nrounds_for_depth(tile.depth, cfg))
                     for tile in batch]
        with profiling.span("upload", stages, device):
            packs = _upload_packs(packs, device, keep)
        for tile, out in zip(batch, _decode_batch(
                packs, halo, batch, k=k, cfg=cfg, stages=stages,
                devices=devices)):
            with profiling.span("resolve", stages, device):
                buf[tile.base:tile.base + tile.used] = \
                    out[HALO:HALO + tile.used]
        halo = out[tile.used:tile.used + HALO]
    return buf, keep


def check_sums(total: int, got_adler: int, got_crc, want_adler: int,
               want_crc=None, want_isize=None) -> None:
    """The decode's gates on fetched sums: a non-empty output's adler32
    against the scan's, then for a gzip member (want_crc given) its crc32
    against the trailer and its length against ISIZE mod 2^32."""
    if total and got_adler != want_adler:
        raise ZippyError(
            "Device decode verification failed (output checksum does not "
            "match the scan)")
    if want_crc is None:
        return
    if got_crc != want_crc:
        raise ZippyError("Checksum verification failed")
    if want_isize != total & 0xFFFFFFFF:
        raise ZippyError("Size verification failed")


def _placement(device, devices):
    """(the device that resolves and holds the output, the extraction
    devices or None). With `devices` the output is on the first of them;
    `device`, if given too, must be that one."""
    if devices is None:
        return resolve_device(device), None
    devices = resolve_devices(devices)
    if device is not None and resolve_devices([device])[0] != devices[0]:
        raise ZippyError("device must be the first of devices")
    return devices[0], devices


def inflate_device_array_acc(data: bytes, index, device=None, stages=None, *,
                             adler: bool = True, crc: bool = True,
                             devices=None):
    """Decode a raw DEFLATE stream into a uint8 tensor on `device` (None:
    the CUDA card; "cpu" runs the plain versions) and leave the checksums
    asked for there: nothing is fetched and the host does not wait for the
    card. `index` is the result of build_decode_index; its offsets are
    absolute in `data`. With `devices` (a list; a device may repeat), each
    batch's token extraction is split over them, balanced by busy lanes,
    and the output, the LZ resolution and the checksums are on the first:
    the bytes are those of the one-device decode.

    Returns (buf, total, adler_t, crc_t, keep): buf holds exactly the total
    decoded bytes (a zero-length tensor for an empty stream); adler_t is
    the (1,) int64 adler32 (K1) and crc_t the (1,) int32 raw CRC (K2 + K3,
    finished on the host by checksums.crc32_finish), each None unless asked
    for; keep holds the pinned upload buffers, for the caller to hold until
    it next synchronizes. With a `stages` dict, each stage's synchronized
    seconds are added to it."""
    dev, devices = _placement(device, devices)
    total = int(index["total_out"])
    if total:
        buf, keep = _run_tiles(data, index, dev, stages, devices)
    else:
        buf, keep = torch.empty(0, dtype=torch.uint8, device=dev), []
    with profiling.span("checksums", stages, dev):
        adler_t = checksums.adler32_tensor(buf) if adler else None
        crc_t = checksums.crc32_raw_tensor(buf) if crc else None
    return buf, total, adler_t, crc_t, keep


def inflate_device_array(data: bytes, index=None, start_bit: int = 0,
                         verify: bool = True, device=None, stages=None,
                         devices=None):
    """Decode a raw DEFLATE stream into a uint8 tensor on `device`, as
    inflate_device_array_acc does, scanning it first when `index` is
    omitted. Returns (tensor, total): the tensor holds exactly the
    total_out decoded bytes.

    verify=True fetches the output's adler32 (K1) and raises ZippyError if
    it differs from the scan's: the integrity gate of raw DEFLATE, which
    has no checksum of its own. Neither sum is computed otherwise."""
    dev, devices = _placement(device, devices)
    if index is None:
        with profiling.span("scan", stages, dev):
            index = build_decode_index(data, start_bit)
    buf, total, adler_t, _, keep = inflate_device_array_acc(
        data, index, dev, stages, adler=verify, crc=False, devices=devices)
    if verify:
        with profiling.span("checksums", stages, dev):
            with profiling.span("checksum.wait"):
                got_adler = int(adler_t)
            check_sums(total, got_adler, None, int(index["adler"]))
    # Held to here; without the gate's sync, torch's pinned-memory cache
    # keeps a freed upload buffer until its copy has run.
    del keep
    return buf, total


def _fetch(buf: torch.Tensor, stages=None) -> bytes:
    """The output's bytes on the host (pageable memory)."""
    profiling.count("fetch.bytes", buf.nbytes)
    profiling.count("fetch.used_bytes", buf.nbytes)
    with profiling.span("fetch", stages, buf.device):
        return buf.cpu().numpy().tobytes()


def inflate_device(data: bytes, index=None, start_bit: int = 0,
                   verify: bool = True, device=None, stages=None,
                   devices=None) -> bytes:
    """Decode a raw DEFLATE stream on the card; as inflate_device_array,
    with the bytes fetched to the host."""
    buf, _ = inflate_device_array(data, index, start_bit, verify, device,
                                  stages, devices)
    return _fetch(buf, stages)


def uncompress_zlib_device(blob: bytes, index=None, device=None) -> bytes:
    """Decode one zlib stream on the card. The trailer's adler32 is checked
    against the scan's (on the host), and the device output against the
    same value."""
    if len(blob) < 6:
        raise ZippyError("Invalid compressed data")
    cmf, flg = blob[0], blob[1]
    if (cmf & 0x0F) != 8:
        raise ZippyError("Unsupported compression method")
    if (cmf >> 4) > 7:
        raise ZippyError("Invalid compression info")
    if (cmf * 256 + flg) % 31 != 0:
        raise ZippyError("Invalid header")
    if flg & 0b0010_0000:
        raise ZippyError("Preset dictionary is not yet supported")
    if index is None:
        index = build_decode_index(blob, 16)
    tpos = (int(index["end_bit"]) + 7) // 8
    if tpos + 4 > len(blob):
        raise ZippyError("Invalid compressed data")
    want = int.from_bytes(blob[tpos : tpos + 4], "big")
    if int(index["adler"]) != want:
        raise ZippyError("Checksum verification failed")
    return inflate_device(blob, index, verify=True, device=device)


def uncompress_gzip_device(blob: bytes, index=None, device=None,
                           pos: int = 0) -> bytes:
    """Decode the gzip member at byte `pos` of `blob` on the card. The
    output's adler32 and crc32 come back in one fetch: the adler32 gate,
    then the crc32 against the trailer and the length against ISIZE mod
    2^32; the bytes are fetched once the gates pass."""
    with profiling.span("framing"):
        hdr = gzip_format.parse_header(blob, pos)
    if index is None:
        index = build_decode_index(blob, hdr["data_offset"] * 8)
    with profiling.span("framing"):
        tpos = (int(index["end_bit"]) + 7) // 8
        if tpos + 8 > len(blob):
            raise ZippyError("Invalid gzip data")
        want_crc = int.from_bytes(blob[tpos:tpos + 4], "little")
        want_isize = int.from_bytes(blob[tpos + 4:tpos + 8], "little")
    buf, total, adler_t, crc_t, keep = inflate_device_array_acc(
        blob, index, device)
    with profiling.span("checksum.wait"):
        got_adler, raw_crc = torch.cat([adler_t, crc_t]).tolist()
    del keep
    check_sums(total, got_adler, checksums.crc32_finish(raw_crc, total),
               int(index["adler"]), want_crc, want_isize)
    return _fetch(buf)

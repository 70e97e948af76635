// Hand-written Hopper (sm_90a) kernels for the device checksums.
//
// Built by zippy_tpu_torch/ops/checksum_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: each entry point takes raw device pointers and
// the caller's stream, launches one kernel, allocates nothing, and returns
// the first CUDA error it met (0 when the launch was accepted).
//
// K1 zt_adler_chunks replaces zippy_tpu/ops/pallas_checksums.py
//    `_adler_tile_kernel` (:32). For every 1024-byte chunk:
//      S = sum byte_i,  W = sum (1024 - i) * byte_i,  both mod 65521.
//    Bound: bytes. It reads each input byte once and writes 8 bytes per chunk,
//    so its least time is (n + n/128) bytes / the card's HBM rate. Design:
//    64 threads per chunk each load one 16-byte vector (neighbouring threads
//    on neighbouring addresses), accumulate S and W in uint32 (W < 1.34e8),
//    reduce with __shfl_down_sync inside each warp, and join the chunk's two
//    warps through shared memory. 4 chunks per 256-thread block.
//
// K2 zt_crc_rows replaces the kernel built by `_make_crc_tile_kernel`
//    (pallas_checksums.py:134, kernel at :139). For every 512-byte row it
//    writes the row's raw CRC (register init 0, no final xor); an optional
//    tail of fewer than 512 bytes counts as one more row, padded with zeros
//    at its front (leading zeros do not change a raw CRC).
//    Bound: bytes: each input byte read once, 4 bytes written per row,
//    (n + n/128) bytes / the HBM rate. A GF(2) product done as 32
//    select-XORs (the TPU kernel's form) costs about 96 integer
//    instructions, which made the first port of K2 bound by integer issue
//    at 16x its bytes bound. Design: every GF(2)-linear map of a 32-bit
//    word splits by byte into 4 tables of 256 words, T[j][b] = M (b << 8j),
//    so a product is 4 shared-memory lookups and 3 XORs.
//    - One warp per row; each lane loads one 16-byte vector (neighbouring
//      lanes on neighbouring addresses) and takes its raw CRC by
//      slicing-by-16: 16 tables, D[k][b] = raw CRC of byte b followed by k
//      zero bytes (16 KB).
//    - The 32 lane values join inside the warp, with no __syncthreads:
//      lane l applies its own shift over 16 (31 - l) bytes (4 tables per
//      lane, 128 KB), then one __reduce_xor_sync; 20 lookups per 16 bytes.
//      (Five __shfl_down_sync levels with shared shift tables, 36 lookups
//      per 16 bytes, took 1.7x as long on the H100.)
//    - The tables are one device buffer built on the host and cached per
//      device; each block copies its 144 KB into dynamic shared memory.
//      A lane's 4 tables start one bank after the previous lane's, so an
//      all-zero row reads no bank twice: the conflict-free control.
//    - Persistent blocks (as many as fit on each SM) walk the rows in a
//      grid-stride loop, with two rows in flight ahead of the one being
//      folded; the first two load while the block copies its tables.
//
// K3 zt_crc_combine replaces the jnp log-tree `_crc_combine_rows`
//    (pallas_checksums.py:188). It folds nrows raw row CRCs, where every
//    row is 512 bytes but the last, which has last_bytes (1..512), into the
//    raw CRC of the whole. Bound: bytes, 4 per row read once (0.00016 ms
//    for 131072 rows), far below what one launch costs. Beyond the launch
//    its time is a chain of dependent steps (row loads, table staging,
//    table products, the blocks' meeting), and, on many rows, the lookups
//    themselves: a fold of n values needs n - 1 GF(2) products, and one
//    SM does them at a few hundred cycles per thousand, so the rows are
//    spread over up to 512 blocks. Design: one launch of 2^lg blocks
//    (lg <= 9) of 64 threads, L = 64 * 2^lg lanes, at least 4 rows a lane
//    when the rows allow; no fill before it, one store of the result.
//    - Tables: a product is 8 lookups in nibble tables, N[j][e] = M (e <<
//      4j), 128 words a map. Each of its 8 tables sits in 16 distinct
//      banks, so a warp's lookup never waits on a bank conflict (4 byte
//      tables of 256 words do, about 3-way at random banks), and a block
//      stages the 8 maps it reads in 4 KB, one 16-byte load a thread.
//    - Lattice: lane g folds the full rows g, g + L, ... (zero rows in
//      front up to a multiple of L; coalesced loads, 8 in flight) by
//      Horner's rule with the shift over 512 L bytes.
//    - Tree: each block folds its lanes' sums pairwise by levels; at level
//      k the survivor takes shift(512 * 2^k bytes)(left) ^ right, with the
//      same map for every active lane: levels 0-4 by shuffles in each
//      warp, 5 in warp 0 over the two warps' sums.
//    - Meeting: block b shifts its sum over the 2^lg - 1 - b blocks after
//      it (one product: the buffer holds the map of every distance) and
//      XORs it, with its bit of the group, into its group's 64-bit meeting
//      word: low half the XOR of the parts, high half one bit for each of
//      the group's up to 32 blocks. atomicXor returns the word as it was,
//      so the block that completes the mask holds the group's sum with no
//      second read and no fence; it clears the word and, over 32 blocks,
//      meets the other groups' last blocks the same way in one more word.
//      The last block applies the shift over the last row's bytes (32
//      columns passed by value, one warp reduction), XORs in that row's
//      CRC and stores the result.
//    - Meeting words: one set per stream slot (checksum_kernels picks the
//      slot of the caller's stream), zero when the module loads and left
//      zero by every launch, so no fill runs before a launch. Calls on one
//      stream run one after another; calls on two streams use two slots,
//      and a CUDA graph replays the slot of the stream it was captured on.
//    Measured on the H100 and not kept (bench_k3_designs.py): one
//    thread-block cluster of up to 16 blocks meeting in distributed shared
//    memory (too few SMs for the lookups), a cooperative grid with
//    grid.sync, a last-block ticket behind __threadfence with the parts in
//    global memory (two fences and a second read in the tail), and byte
//    tables (8x the staging); PERF.md has the numbers.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "device_scope.cuh"

namespace {

constexpr int kChunk = 1024;
constexpr uint32_t kMod = 65521;
constexpr int kThreadsPerChunk = kChunk / 16;  // 64: one uint4 each
constexpr int kChunksPerBlock = 4;
constexpr int kAdlerThreads = kThreadsPerChunk * kChunksPerBlock;

// The crc table buffer (checksum_kernels._crc_tables), in uint32 words:
// slice tables D[16][256], lane tables S[32][4][256] (lane l: the shift
// over 16 (31 - l) bytes), shift levels N[25][8][16] (level b: the nibble
// tables of the shift over 2^b bytes; K3 reads levels 9 and up), distance
// maps N[512][8][16] (map d: the shift over d of K3's blocks).
constexpr int kTable = 4 * 256;                 // one map's 4 byte tables
constexpr int kMap = 8 * 16;                    // one map's 8 nibble tables
constexpr int kSliceWords = 16 * 256;
constexpr int kLaneWords = 32 * kTable;
constexpr int kShiftOffset = kSliceWords + kLaneWords;
constexpr int kLaneStride = kTable + 1;         // in shared: one bank apart

constexpr int kRowBytes = 512;
constexpr int kCrcThreads = 1024;
constexpr int kCrcWarps = kCrcThreads / 32;
constexpr size_t kCrcSmem = (kSliceWords + 32 * kLaneStride) * 4;

constexpr int kCombineThreads = 64;
constexpr int kCombineWarps = kCombineThreads / 32;
constexpr int kCombineMaxLg = 9;                // at most 512 blocks
constexpr int kGroupLg = 5;                     // blocks meet in groups of 32
constexpr int kGroups = 1 << (kCombineMaxLg - kGroupLg);
constexpr int kCombineSlots = 1024;             // meeting word sets
constexpr int kRowLevel = 9;                    // the shift over one row
constexpr int kTreeLevels = 6;                  // levels 9-14: a block's tree
constexpr int kBlockLevel = kRowLevel + kTreeLevels;  // over 64 rows
constexpr int kShiftLevels = kBlockLevel + kCombineMaxLg + 1;
constexpr int kDistanceMaps = 1 << kCombineMaxLg;
constexpr int kRowBatch = 8;                    // Horner row loads in flight
// Staged maps: the tree's, the Horner step's, the block's distance map.
constexpr int kStagedMaps = kTreeLevels + 2;
static_assert(1 << kTreeLevels == kCombineThreads, "one level per halving");
static_assert(kCombineMaxLg >= kGroupLg && kGroups <= 32, "two meetings");

// K3's meeting words: [slot][0] meets the groups, [slot][1 + g] the blocks
// of group g. Zero at load; each launch leaves its slot's words zero.
__device__ unsigned long long g_meet[kCombineSlots][1 + kGroups];

// The shift over the last row's bytes as 32 columns, passed by value.
struct LastColumns {
  uint32_t col[32];
};

constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kAdlerThreads)
adler_chunks_kernel(const uint4* __restrict__ data, long long nchunks,
                    int32_t* __restrict__ s_out, int32_t* __restrict__ w_out) {
  __shared__ uint32_t sh_s[kAdlerThreads / 32];
  __shared__ uint32_t sh_w[kAdlerThreads / 32];
  const int local = threadIdx.x / kThreadsPerChunk;
  const int t = threadIdx.x % kThreadsPerChunk;
  const long long chunk = (long long)blockIdx.x * kChunksPerBlock + local;
  uint32_t s = 0, w = 0;
  if (chunk < nchunks) {
    const uint4 v = data[chunk * kThreadsPerChunk + t];
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint32_t weight = kChunk - 16 * t;  // weight of this thread's first byte
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (words[i] >> (8 * b)) & 0xFFu;
        s += byte;
        w += weight * byte;
        --weight;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
    w += __shfl_down_sync(0xFFFFFFFFu, w, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sh_s[warp] = s;
    sh_w[warp] = w;
  }
  __syncthreads();
  if (threadIdx.x < kChunksPerBlock) {
    const long long c = (long long)blockIdx.x * kChunksPerBlock + threadIdx.x;
    if (c < nchunks) {
      const int w0 = 2 * threadIdx.x;  // a chunk is two warps
      s_out[c] = (int32_t)((sh_s[w0] + sh_s[w0 + 1]) % kMod);
      w_out[c] = (int32_t)((sh_w[w0] + sh_w[w0 + 1]) % kMod);
    }
  }
}

// M v for a map M given as 4 byte tables t[j * 256 + b].
__device__ __forceinline__ uint32_t apply_tables(const uint32_t* t,
                                                 uint32_t v) {
  return t[v & 0xFFu] ^ t[256 + ((v >> 8) & 0xFFu)] ^
         t[512 + ((v >> 16) & 0xFFu)] ^ t[768 + (v >> 24)];
}

// Raw CRC of 16 stream bytes (a little-endian uint4): byte p is followed by
// 15 - p bytes, so it looks up D[15 - p].
__device__ __forceinline__ uint32_t slice16(const uint32_t* d, uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t c = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      c ^= d[(15 - 4 * q - b) * 256 + ((w[q] >> (8 * b)) & 0xFFu)];
  }
  return c;
}

// This lane's 16 bytes of row `row`: a full row, or the tail row (its
// bytes at the end, zeros in front), or zeros past the end.
__device__ __forceinline__ uint4 load_row(const uint4* __restrict__ rows,
                                          long long nrows,
                                          const uint8_t* __restrict__ tail,
                                          int tail_len, long long row,
                                          int lane) {
  if (row < nrows) return __ldg(rows + row * (kRowBytes / 16) + lane);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row == nrows && tail_len > 0) {
    const int first = 16 * lane - (kRowBytes - tail_len);
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      if (first + p >= 0)
        w[p >> 2] |= (uint32_t)tail[first + p] << (8 * (p & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kCrcThreads)
crc_rows_kernel(const uint4* __restrict__ rows, long long nrows,
                const uint8_t* __restrict__ tail, int tail_len,
                int32_t* __restrict__ out,
                const uint32_t* __restrict__ tables) {
  extern __shared__ uint32_t sh[];
  // The first two rows are in flight while the block copies its tables.
  const int lane = threadIdx.x % 32;
  const long long total = nrows + (tail_len > 0 ? 1 : 0);
  const long long stride = (long long)gridDim.x * kCrcWarps;
  long long row = (long long)blockIdx.x * kCrcWarps + threadIdx.x / 32;
  uint4 cur = load_row(rows, nrows, tail, tail_len, row, lane);
  uint4 next = load_row(rows, nrows, tail, tail_len, row + stride, lane);
  for (int i = threadIdx.x; i < kSliceWords + kLaneWords; i += kCrcThreads) {
    const int k = i - kSliceWords;  // lane tables: one padded block per lane
    const int to = i < kSliceWords
                       ? i
                       : kSliceWords + (k / kTable) * kLaneStride + k % kTable;
    sh[to] = tables[i];
  }
  __syncthreads();
  const uint32_t* shift = sh + kSliceWords + lane * kLaneStride;
  for (; row < total; row += stride) {  // warp-uniform
    const uint4 after = load_row(rows, nrows, tail, tail_len, row + 2 * stride,
                                 lane);
    const uint32_t v =
        __reduce_xor_sync(kFull, apply_tables(shift, slice16(sh, cur)));
    if (lane == 0) out[row] = (int32_t)v;
    cur = next;
    next = after;
  }
}

// M v for a map M given as 8 nibble tables t[j * 16 + e].
__device__ __forceinline__ uint32_t apply_nibbles(const uint32_t* t,
                                                  uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r ^= t[16 * j + ((v >> (4 * j)) & 15u)];
  return r;
}

// One pairwise level of the fold across a warp: lanes that are multiples of
// 2 * span take M left ^ right, right being the sum `span` lanes on.
__device__ __forceinline__ uint32_t fold_level(const uint32_t* map,
                                               uint32_t v, int lane,
                                               int span) {
  const uint32_t right = __shfl_down_sync(kFull, v, span);
  return lane % (2 * span) == 0 ? apply_nibbles(map, v) ^ right : v;
}

// Warp-wide: XOR `part` (lane 0's) and the bit of `member` (< members <=
// 32) into a meeting word. Returns whether this call completed the
// members' mask; then `part` becomes the XOR of every member's part, and
// the word is cleared for the next launch on this slot.
__device__ __forceinline__ bool meet(unsigned long long* word, uint32_t& part,
                                     unsigned member, unsigned members,
                                     int lane) {
  unsigned long long old = 0;
  if (lane == 0)
    old = atomicXor(word, (unsigned long long)(1u << member) << 32 | part);
  old = __shfl_sync(kFull, old, 0);
  if (((unsigned)(old >> 32) | 1u << member) != kFull >> (32 - members))
    return false;
  part ^= (uint32_t)old;
  if (lane == 0) *word = 0;
  return true;
}

// levels: the table buffer's shift levels, then its distance maps.
__global__ void __launch_bounds__(kCombineThreads)
crc_combine_kernel(const uint32_t* __restrict__ crcs, long long nrows, int lg,
                   const uint4* __restrict__ levels,
                   const __grid_constant__ LastColumns last, int slot,
                   uint32_t* __restrict__ out) {
  __shared__ uint4 staged[kStagedMaps * kMap / 4];
  __shared__ uint32_t warp_sums[kCombineWarps];
  const uint32_t* maps = reinterpret_cast<const uint32_t*>(staged);
  const unsigned block = blockIdx.x;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;

  // The full rows 0 .. nrows - 2, with zero rows in front up to a multiple
  // of the L lanes: lane g takes padded rows g + L j, j < steps. The first
  // batch of rows, and the last row, load while the block stages.
  const long long lanes = (long long)kCombineThreads << lg;
  const long long nfull = nrows - 1;
  const long long steps = (nfull + lanes - 1) / lanes;
  const long long first =
      (long long)block * kCombineThreads + t - (steps * lanes - nfull);
  const uint32_t last_row = warp == 0 ? __ldg(crcs + nfull) : 0u;
  uint32_t batch[kRowBatch];
  auto load = [&](long long j0) {
#pragma unroll
    for (int q = 0; q < kRowBatch; ++q) {
      const long long i = first + (j0 + q) * lanes;
      batch[q] = j0 + q < steps && i >= 0 ? __ldg(crcs + i) : 0u;
    }
  };
  load(0);
  // Staged: levels 9-14 (the tree), 15 + lg (512 L bytes: the Horner
  // step), then the distance map of the 2^lg - 1 - block blocks after it.
  constexpr int kVecs = kMap / 4;  // uint4s per map
  const int after = (1 << lg) - 1 - (int)block;
  for (int i = t; i < kStagedMaps * kVecs; i += kCombineThreads) {
    const int s = i / kVecs;
    const int map = s < kTreeLevels    ? kRowLevel + s
                    : s == kTreeLevels ? kBlockLevel + lg
                                       : kShiftLevels + after;
    staged[i] = __ldg(levels + map * kVecs + i % kVecs);
  }
  __syncthreads();

  const uint32_t* horner = maps + kTreeLevels * kMap;
  uint32_t acc = 0;
  for (long long j0 = 0; j0 < steps; j0 += kRowBatch) {
    uint32_t rows[kRowBatch];
#pragma unroll
    for (int q = 0; q < kRowBatch; ++q) rows[q] = batch[q];
    if (j0 + kRowBatch < steps) load(j0 + kRowBatch);
#pragma unroll
    for (int q = 0; q < kRowBatch; ++q)
      if (j0 + q < steps)
        acc = (j0 + q ? apply_nibbles(horner, acc) : 0u) ^ rows[q];
  }

  // The block's tree: levels 0-4 in each warp, 5 in warp 0.
#pragma unroll
  for (int k = 0; k < 5; ++k)
    acc = fold_level(maps + k * kMap, acc, lane, 1 << k);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp != 0) return;
  acc = lane < kCombineWarps ? warp_sums[lane] : 0u;
#pragma unroll
  for (int k = 5; k < kTreeLevels; ++k)
    acc = fold_level(maps + k * kMap, acc, lane, 1 << (k - 5));
  acc = __shfl_sync(kFull, acc, 0);  // the block's sum, in every lane

  // The meeting: the block's part, then in its group, then over the groups.
  if (lg > 0) {
    acc = apply_nibbles(horner + kMap, acc);
    const int group_lg = lg < kGroupLg ? lg : kGroupLg;
    const unsigned members = 1u << group_lg;
    const unsigned member = block % members, group = block >> group_lg;
    if (!meet(&g_meet[slot][1 + group], acc, member, members, lane) ||
        (lg > kGroupLg &&
         !meet(&g_meet[slot][0], acc, group, 1u << (lg - kGroupLg), lane)))
      return;
  }
  acc = __reduce_xor_sync(kFull, (acc >> lane) & 1u ? last.col[lane] : 0u);
  if (lane == 0) *out = acc ^ last_row;
}

// Blocks for a persistent grid: as many as fit on every SM, and no more
// than the work needs.
cudaError_t persistent_grid(const void* kernel, int threads, size_t smem,
                            long long want, int device, long long* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)sms * per_sm;
  *grid = want < fit ? want : fit;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// data: nchunks * 1024 bytes, 16-byte aligned; s_out, w_out: nchunks int32.
int zt_adler_chunks(const void* data, long long nchunks, void* s_out,
                    void* w_out, void* stream, int device) {
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  if (nchunks > 0) {
    const long long grid = (nchunks + kChunksPerBlock - 1) / kChunksPerBlock;
    adler_chunks_kernel<<<(unsigned)grid, kAdlerThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint4*)data, nchunks, (int32_t*)s_out, (int32_t*)w_out);
  }
  return (int)cudaGetLastError();
}

// rows: nrows * 512 bytes, 16-byte aligned; tail: tail_len < 512 bytes, any
// alignment (unused when tail_len is 0); out: nrows + (tail_len > 0) int32;
// tables: the device table buffer.
int zt_crc_rows(const void* rows, long long nrows, const void* tail,
                int tail_len, void* out, const void* tables, void* stream,
                int device) {
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = nrows + (tail_len > 0 ? 1 : 0);
  if (total > 0) {
    long long grid = 0;
    err = persistent_grid((const void*)crc_rows_kernel, kCrcThreads, kCrcSmem,
                          (total + kCrcWarps - 1) / kCrcWarps, device, &grid);
    if (err != cudaSuccess) return (int)err;
    crc_rows_kernel<<<(unsigned)grid, kCrcThreads, kCrcSmem,
                      (cudaStream_t)stream>>>(
        (const uint4*)rows, nrows, (const uint8_t*)tail, tail_len,
        (int32_t*)out, (const uint32_t*)tables);
  }
  return (int)cudaGetLastError();
}

// crcs: nrows >= 1 int32 raw row CRCs (the last row may be short); lg:
// log2 of the blocks, 0..9, from checksum_kernels (so that the plain
// version folds in the same order); levels: the table buffer's shift
// levels and distance maps, 16-byte aligned; last: the 32 uint32 host columns of the shift
// over the last row's bytes; slot: the caller's stream's meeting words,
// 0..1023; out: one int32, written once.
int zt_crc_combine(const void* crcs, long long nrows, int lg,
                   const void* levels, const uint32_t* last, int slot,
                   void* out, void* stream, int device) {
  if (nrows < 1 || lg < 0 || lg > kCombineMaxLg || slot < 0 ||
      slot >= kCombineSlots)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  LastColumns cols;
  memcpy(cols.col, last, sizeof(cols.col));
  crc_combine_kernel<<<1u << lg, kCombineThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)crcs, nrows, lg, (const uint4*)levels, cols, slot,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

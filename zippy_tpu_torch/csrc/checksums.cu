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
//    raw CRC of the whole. Bound: bytes, 4 per row read once. Each row costs
//    one GF(2) product, 4 lookups at random banks, so one SM's shared
//    memory would take about 0.03 ms for 131072 rows: the work is spread
//    over up to 128 blocks. Design: 2^lg blocks of 1024 threads, L =
//    1024 * 2^lg threads in all, at least one full row each when the rows
//    allow. Thread g folds the rows g, g + L, ... (zero rows in front;
//    coalesced reads) by Horner's rule with the shift over 512 L bytes,
//    then shifts its sum over the rows behind it, 512 (L - 1 - g) bytes,
//    by the set bits of L - 1 - g. Each block XORs its threads' sums (a
//    warp reduction and one step through shared memory), shifts the result
//    over last_bytes, and XORs it into the zeroed output with atomicXor;
//    block 0 adds the last row. Shift levels: byte tables of the shift over
//    2^b bytes, b = 0 .. 19 + lg (at most 27 levels, 108 KB of shared
//    memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;
constexpr uint32_t kMod = 65521;
constexpr int kThreadsPerChunk = kChunk / 16;  // 64: one uint4 each
constexpr int kChunksPerBlock = 4;
constexpr int kAdlerThreads = kThreadsPerChunk * kChunksPerBlock;

// The crc table buffer (checksum_kernels._crc_tables), in uint32 words:
// slice tables D[16][256], lane tables S[32][4][256] (lane l: the shift
// over 16 (31 - l) bytes), shift levels L[27][4][256] (the shift over 2^b
// bytes).
constexpr int kTable = 4 * 256;                 // one map's 4 byte tables
constexpr int kSliceWords = 16 * 256;
constexpr int kLaneWords = 32 * kTable;
constexpr int kShiftLevels = 27;
constexpr int kShiftOffset = kSliceWords + kLaneWords;
constexpr int kLaneStride = kTable + 1;         // in shared: one bank apart

constexpr int kRowBytes = 512;
constexpr int kCrcThreads = 1024;
constexpr int kCrcWarps = kCrcThreads / 32;
constexpr size_t kCrcSmem = (kSliceWords + 32 * kLaneStride) * 4;

constexpr int kCombineThreads = 1024;
constexpr int kCombineMaxLg = 7;                // at most 2^7 blocks
constexpr size_t kCombineSmem = kShiftLevels * kTable * 4;

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

__global__ void __launch_bounds__(kCombineThreads)
crc_combine_kernel(const uint32_t* __restrict__ crcs, long long nrows,
                   int last_bytes, int lg, const uint32_t* __restrict__ levels,
                   uint32_t* __restrict__ out) {
  extern __shared__ uint32_t lv[];
  __shared__ uint32_t part[kCombineThreads / 32];
  for (int i = threadIdx.x; i < (20 + lg) * kTable; i += kCombineThreads)
    lv[i] = levels[i];
  __syncthreads();
  // The full rows 0 .. nrows - 2, with zero rows in front up to a multiple
  // of the 1024 * 2^lg threads: thread g takes padded rows g + lanes * j.
  const long long lanes = (long long)kCombineThreads << lg;
  const long long g = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  const long long nfull = nrows - 1;
  const long long steps = (nfull + lanes - 1) / lanes;
  const long long first = g - (steps * lanes - nfull);
  const uint32_t* horner = lv + (19 + lg) * kTable;  // 512 * lanes bytes
  uint32_t acc = 0;
  for (long long j = 0; j < steps; ++j) {
    const long long i = first + j * lanes;
    acc = apply_tables(horner, acc) ^ (i >= 0 ? __ldg(crcs + i) : 0u);
  }
  const long long behind = lanes - 1 - g;  // rows after this thread's
  for (int b = 0; b < 10 + lg; ++b)
    if ((behind >> b) & 1) acc = apply_tables(lv + (9 + b) * kTable, acc);
  acc = __reduce_xor_sync(kFull, acc);
  const int t = threadIdx.x;
  if (t % 32 == 0) part[t / 32] = acc;
  __syncthreads();
  if (t < 32) {
    uint32_t f = __reduce_xor_sync(kFull, part[t]);
    if (t == 0) {
      // The shift over the last row is linear: each block applies it to
      // its own part before the parts meet.
#pragma unroll
      for (int b = 0; b < 10; ++b)
        if ((last_bytes >> b) & 1) f = apply_tables(lv + b * kTable, f);
      if (blockIdx.x == 0) f ^= __ldg(crcs + nrows - 1);
      atomicXor(out, f);
    }
  }
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
  cudaError_t err = cudaSetDevice(device);
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
  cudaError_t err = cudaSetDevice(device);
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

// crcs: nrows >= 1 int32 raw row CRCs; last_bytes: the last row's length,
// 1..512; levels: the table buffer's shift levels; out: one int32, zero
// before the launch (the blocks XOR their parts into it).
int zt_crc_combine(const void* crcs, long long nrows, int last_bytes,
                   const void* levels, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(crc_combine_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kCombineSmem);
  if (err != cudaSuccess) return (int)err;
  int lg = 0;  // 2^lg blocks: enough threads for one full row each
  while (lg < kCombineMaxLg && ((long long)kCombineThreads << lg) < nrows - 1)
    ++lg;
  crc_combine_kernel<<<1u << lg, kCombineThreads, (20 + lg) * kTable * 4,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)crcs, nrows, last_bytes, lg, (const uint32_t*)levels,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

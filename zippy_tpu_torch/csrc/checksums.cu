// Hand-written Hopper (sm_90a) kernels for the device checksums.
//
// Built by zippy_tpu_torch/ops/checksum_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: each entry point takes raw device pointers and
// the caller's stream, launches one kernel, allocates nothing, and returns
// cudaGetLastError().
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
//    (pallas_checksums.py:134, kernel at :139). For every row of 128
//    little-endian words (512 bytes) it writes the row's raw CRC.
//    Bound: bytes: it reads each input byte once and writes 4 bytes per
//    row, (n + n/128) bytes / the HBM rate. This design does not reach it:
//    its 32 select-XORs per GF(2) product (255 products a row) are integer
//    work that takes longer than the reads.
//    Design: one thread per word computes the word's raw CRC as a GF(2)
//    matrix-vector product, 32 select-XORs against constant columns. The row
//    (4 warps) then folds in 7 levels, v_i <- shift^(4h)(v_i) ^ v_{i+h} with
//    h = 64, 32, ..., 1 words: the first 2 through shared memory, the last 5
//    with shuffles in the row's first warp. The 8 x 32 matrix columns are a
//    __grid_constant__ kernel parameter, which the card holds in its
//    constant bank, so every lane reads the same column at the same time as
//    __constant__ data.
//    2 rows per block.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kChunk = 1024;
constexpr uint32_t kMod = 65521;
constexpr int kThreadsPerChunk = kChunk / 16;  // 64: one uint4 each
constexpr int kChunksPerBlock = 4;
constexpr int kAdlerThreads = kThreadsPerChunk * kChunksPerBlock;

constexpr int kRowWords = 128;
constexpr int kRowsPerBlock = 2;
constexpr int kCrcThreads = kRowWords * kRowsPerBlock;

struct CrcMats {
  // col[0]: raw CRC of each bit of a LE word; col[r], r = 1..7: the shift
  // over 4 * 2^(r-1) bytes.
  uint32_t col[8][32];
};

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

__device__ __forceinline__ uint32_t gf2_apply(const uint32_t (&cols)[32],
                                              uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) r ^= (0u - ((v >> j) & 1u)) & cols[j];
  return r;
}

__global__ void __launch_bounds__(kCrcThreads)
crc_rows_kernel(const uint32_t* __restrict__ words, long long nrows,
                int32_t* __restrict__ out, const __grid_constant__ CrcMats mats) {
  __shared__ uint32_t sh[kRowsPerBlock][kRowWords];
  const int local = threadIdx.x / kRowWords;
  const int t = threadIdx.x % kRowWords;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + local;
  uint32_t v = 0;
  if (row < nrows) v = gf2_apply(mats.col[0], words[row * kRowWords + t]);

  // Halves of 64 and 32 words span warps: fold through shared memory.
  sh[local][t] = v;
  __syncthreads();
  if (t < 64) v = gf2_apply(mats.col[7], v) ^ sh[local][t + 64];
  __syncthreads();
  sh[local][t] = v;
  __syncthreads();
  if (t < 32) v = gf2_apply(mats.col[6], v) ^ sh[local][t + 32];

  // Halves of 16..1 words lie inside the row's first warp; the other warps
  // are done. Every lane of it takes part in the shuffles; lane 0 keeps the
  // result.
  if (t >= 32) return;
  v = gf2_apply(mats.col[5], v) ^ __shfl_down_sync(0xFFFFFFFFu, v, 16);
  v = gf2_apply(mats.col[4], v) ^ __shfl_down_sync(0xFFFFFFFFu, v, 8);
  v = gf2_apply(mats.col[3], v) ^ __shfl_down_sync(0xFFFFFFFFu, v, 4);
  v = gf2_apply(mats.col[2], v) ^ __shfl_down_sync(0xFFFFFFFFu, v, 2);
  v = gf2_apply(mats.col[1], v) ^ __shfl_down_sync(0xFFFFFFFFu, v, 1);
  if (t == 0 && row < nrows) out[row] = (int32_t)v;
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

// words: nrows * 128 uint32, 4-byte aligned; out: nrows int32;
// mats: host pointer to the 8 x 32 uint32 matrix columns.
int zt_crc_rows(const void* words, long long nrows, void* out,
                const void* mats, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nrows > 0) {
    CrcMats m;
    memcpy(&m, mats, sizeof(m));
    const long long grid = (nrows + kRowsPerBlock - 1) / kRowsPerBlock;
    crc_rows_kernel<<<(unsigned)grid, kCrcThreads, 0,
                      (cudaStream_t)stream>>>(
        (const uint32_t*)words, nrows, (int32_t*)out, m);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernel for the encoder's stream join.
//
// Built by zippy_tpu_torch/ops/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: the entry point takes raw device pointers and the
// caller's stream, launches one kernel, allocates nothing, and returns the
// first CUDA error it met (0 when the launch was accepted).
//
// K10 zt_join_rows replaces no TPU kernel. zippy_tpu joins the encoded
//    blocks of a stream on the host (deflate_device.py's _assemble_block
//    over a _ByteBitAppender), and so did the port before K10: every row's
//    packed words came back whole, about 6.7 bytes for each stream byte,
//    and the host shifted each block into place in numpy, about half of a
//    compress call. K10 joins an encode group's rows into one piece of the
//    stream on the card, so the host fetches only the stream's bytes. Its
//    plain version is join_kernels.join_rows_plain, whose piece and state
//    it equals byte for byte.
//
//    A row j of the group is one DEFLATE block, LSB-first: its 3 block bits
//    (BFINAL, BTYPE), then for a dynamic row (mode 2) the hdr_bits[j] bits
//    of its header (hdr_words, K5), then its nbits[j] payload bits (words,
//    K8). A stored row (mode 0) is one chunk per 65,535 bytes of its block:
//    3 block bits, zero bits up to a byte boundary of the whole stream, LEN
//    and NLEN (16 bits each), the chunk's bytes (raw, from the group's
//    rows). BFINAL is set on the stream's last block (`last`), on a stored
//    row's last chunk. The piece starts at a byte boundary of the stream:
//    its first bit `x0`, the group's start phase (0..7), is what the
//    previous group's join wrote to the state, and its bits before x0 are
//    zero (the host ORs that byte onto the previous piece's last).
//
//    Row offsets. Row j covers bits [S_j, S_{j+1}) of the piece, S_0 = x0.
//    A stored row's length depends on its start: its first LEN starts at
//    ceil8(S_j + 3). So each row is a map of its start bit to its end bit,
//    x -> x + a (fixed, dynamic) or x -> ceil8(x + a) + b (stored), and
//    the maps compose within that family (ceil8(ceil8(y) + c) = ceil8(y) +
//    ceil8(c) for integer c). One warp scans them: two rows a lane, five
//    shuffle steps over at most kMaxRows = 64 rows. Every CTA scans the
//    whole group for itself (64 rows of 4 int64 values from L2), so that no
//    CTA waits on another.
//
//    Bound: the bytes. Each output word is written once, each payload word
//    a row uses is read once (its words past nbits are never read), a
//    stored row's bytes once; per word a few integer operations.
//    Design: one launch a group, a grid of rows x kSplit CTAs of kThreads
//    threads (220 CTAs for a 55-row level-6 group, so that every SM has
//    work). The piece's words are owned, not shared: word w is written by
//    the row that holds its first bit, 32 w (row 0 also owns the words of
//    bits before x0), by a plain store. So no word takes an atomic, and
//    the piece needs no fill before the launch. A row's owned words:
//    - the interior of a fixed or dynamic row's payload (bits 32 w ..
//      32 w + 31 all payload bits): one funnel shift of two neighbouring
//      payload words. Lanes take consecutive 4-word vectors of the payload
//      by 16-byte loads (scalar loads where the row is not 16-byte aligned
//      or runs past its words), the fifth word from the next lane by a
//      shuffle, and store four words each, neighbouring lanes on
//      neighbouring words;
//    - the rest (the block bits, the dynamic header, a stored row, and the
//      row's last word, which holds the first bits of the rows after it):
//      each word gathered from every row it overlaps, by windows of 32
//      bits over each segment of each row (block bits, header words,
//      payload words, a stored chunk's 35-42 bits before its bytes, its
//      bytes).
//    Inputs are clamped where they would send a read past its array: a
//    payload of more bits than 32 wn (tokens that are no cover), a header
//    of more than 32 kHdrWords bits, a mode other than 0-2 (read as fixed),
//    a block longer than block_size or than its row; each sets a bit of
//    the group's error word, and so does a piece longer than its cap_words
//    words, past which nothing is stored. The host refuses a group whose
//    error word is not 0 (deflate_device._fetch_piece).
//    CTA (0, 0) writes the group's state row group + 1: the next group's
//    phase (end bit & 7), the group's bits (end - x0), the piece bit just
//    past the 3 block bits of its first stored row with a byte (-1 when it
//    has none: where a run that did not start at stream bit 0 must be
//    realigned, deflate_device._append_run), the error word. It reads row
//    `group` and writes row group + 1 of a per-run array, so no launch
//    reads what it writes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

// The inputs and outputs; zippy_tpu_torch/ops/join_kernels._Args has the
// same fields in the same order.
struct JoinArgs {
  const long long* mode;       // (G,) 0 stored, 1 fixed, 2 dynamic
  const long long* nbits;      // (G,) payload bits
  const long long* hdr_bits;   // (G,) a dynamic row's header bits
  const long long* lens;       // (G,) block bytes
  const uint32_t* hdr_words;   // (G, kHdrWords)
  const uint32_t* words;       // (G, wn)
  const uint8_t* raw;          // (G, raw_stride), the block at raw_offset
  long long* state;            // (groups + 1, 4)
  uint32_t* piece;             // (cap_words,)
};

namespace {

constexpr int kThreads = 256;
constexpr int kSplit = 4;
constexpr int kMaxRows = 64;
constexpr int kHdrWords = 72;
constexpr long long kChunk = 0xFFFF;
// Bits of the error word (join_kernels.ERRORS).
constexpr long long kWordsOverflow = 1, kHeaderOverflow = 2, kBadMode = 4,
                    kBlockLength = 8, kCapacity = 16;

__device__ __forceinline__ long long ceil8(long long x) {
  return (x + 7) & ~7ll;
}

__device__ __forceinline__ long long ceil32(long long x) {
  return (x + 31) >> 5;
}

// A row's map of its start bit to its end bit: x + a (k = 0) or
// ceil8(x + a) + b (k = 1).
struct Fn {
  int k;
  long long a, b;
};

__device__ __forceinline__ Fn identity() { return Fn{0, 0, 0}; }

// f, then g.
__device__ __forceinline__ Fn then(Fn f, Fn g) {
  if (g.k == 0)
    return f.k == 0 ? Fn{0, f.a + g.a, 0} : Fn{1, f.a, f.b + g.a};
  return f.k == 0 ? Fn{1, f.a + g.a, g.b}
                  : Fn{1, f.a, ceil8(f.b + g.a) + g.b};
}

__device__ __forceinline__ long long apply(Fn f, long long x) {
  return f.k ? ceil8(x + f.a) + f.b : x + f.a;
}

__device__ __forceinline__ Fn shfl_up(Fn f, int d) {
  return Fn{__shfl_up_sync(0xffffffffu, f.k, d),
            __shfl_up_sync(0xffffffffu, f.a, d),
            __shfl_up_sync(0xffffffffu, f.b, d)};
}

__device__ __forceinline__ long long chunks(long long len) {
  return (len + kChunk - 1) / kChunk;
}

__device__ __forceinline__ Fn row_fn(int mode, long long nb, long long hb,
                                     long long len) {
  if (mode != 0) return Fn{0, 3 + hb + nb, 0};
  if (len == 0) return identity();
  // The first chunk: 3 bits, the pad, 32 bits, its bytes; each further
  // chunk starts on a byte: 3 + 5 + 32 bits and its bytes.
  return Fn{1, 3, 32 + 8 * len + 40 * (chunks(len) - 1)};
}

// Bits [o, o + 32) of an n-bit string, as bits 0..31; bits outside
// [0, n) read 0. o may be negative.
__device__ __forceinline__ uint32_t const_window(uint64_t v, int n,
                                                 long long o) {
  if (o >= n || o <= -32) return 0u;
  if (n < 64) v &= (1ull << n) - 1;
  return o >= 0 ? (uint32_t)(v >> o) : (uint32_t)(v << -o);
}

// The same over n bits held LSB-first in words p (bit i is bit i % 32 of
// p[i / 32]); words past ceil(n / 32) are never read.
__device__ __forceinline__ uint32_t words_window(const uint32_t* p,
                                                 long long n, long long o) {
  if (n <= 0 || o >= n || o <= -32) return 0u;
  uint32_t v;
  if (o >= 0) {
    const long long i = o >> 5;
    const int r = (int)(o & 31);
    const uint32_t lo = __ldg(p + i);
    const uint32_t hi = (r && 32 * (i + 1) < n) ? __ldg(p + i + 1) : 0u;
    v = __funnelshift_r(lo, hi, r);
  } else {
    v = __ldg(p) << (int)(-o);
  }
  const long long left = n - o;
  return left < 32 ? v & ((1u << left) - 1u) : v;
}

// The same over the 8 * n bits of n bytes.
__device__ __forceinline__ uint32_t bytes_window(const uint8_t* p,
                                                 long long n, long long o) {
  if (o >= 8 * n || o <= -32) return 0u;
  const long long b = o >> 3;  // floor
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const long long q = b + k;
    if (q >= 0 && q < n) acc |= (uint64_t)__ldg(p + q) << (8 * k);
  }
  return (uint32_t)(acc >> (o & 7));
}

// A group's rows as the scan left them in shared memory.
struct Rows {
  const long long* start;  // S_0 .. S_G
  const int* mode;
  const long long *nb, *hb, *len;
  JoinArgs a;
  int rows, wn, last;
  long long raw_stride, raw_offset;

  // Bits [o, o + 32) of row k (o relative to its start).
  __device__ uint32_t window(int k, long long o) const {
    const bool final = k == last;
    if (mode[k] != 0) {
      const uint32_t head = (final ? 1u : 0u) | (mode[k] == 1 ? 2u : 4u);
      uint32_t v = const_window(head, 3, o);
      if (mode[k] == 2)
        v |= words_window(a.hdr_words + (long long)k * kHdrWords, hb[k],
                          o - 3);
      return v | words_window(a.words + (long long)k * wn, nb[k],
                              o - 3 - hb[k]);
    }
    const uint8_t* bytes = a.raw + k * raw_stride + raw_offset;
    uint32_t v = 0u;
    long long t = 0, done = 0;
    for (int c = 0; done < len[k]; ++c) {
      if (t >= o + 32) break;
      const long long n = min(len[k] - done, kChunk);
      const int pad = c == 0 ? (int)((-(start[k] + 3)) & 7) : 5;
      const int q = 35 + pad;
      if (t + q + 8 * n > o) {
        const uint64_t pre =
            ((final && done + n == len[k]) ? 1ull : 0ull) |
            (uint64_t)n << (3 + pad) |
            (uint64_t)(n ^ kChunk) << (19 + pad);
        v |= const_window(pre, q, o - t) |
             bytes_window(bytes + done, n, o - t - q);
      }
      t += q + 8 * n;
      done += n;
    }
    return v;
  }

  // Piece word w, gathered from row j (its owner) and the rows after it.
  __device__ uint32_t word(long long w, int j) const {
    const long long bit = 32 * w;
    uint32_t v = 0u;
    for (int k = j; k < rows && start[k] < bit + 32; ++k)
      if (start[k + 1] > bit) v |= window(k, bit - start[k]);
    return v;
  }
};

__global__ void __launch_bounds__(kThreads)
join_rows_kernel(JoinArgs a, int rows, int wn, long long raw_stride,
                 long long raw_offset, long long block_size, int last,
                 int group, long long cap_words) {
  __shared__ long long s_start[kMaxRows + 1];
  __shared__ long long s_nb[kMaxRows], s_hb[kMaxRows], s_len[kMaxRows];
  __shared__ int s_mode[kMaxRows];
  const int tid = (int)threadIdx.x, lane = tid & 31;

  if (tid < 32) {
    // The scan of the rows' maps, two rows a lane, in warp 0.
    const long long x0 = a.state[4ll * group];
    const long long len_max = min(block_size, raw_stride - raw_offset);
    long long err = 0;
    Fn f[2];
    bool stored[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * lane + h;
      f[h] = identity();
      stored[h] = false;
      if (k < rows) {
        long long m = a.mode[k], nb = a.nbits[k], hb = a.hdr_bits[k],
                  len = a.lens[k];
        if (m < 0 || m > 2) {
          err |= kBadMode;
          m = 1;
        }
        if (m != 2) hb = 0;
        if (nb < 0 || nb > 32ll * wn) {
          err |= kWordsOverflow;
          nb = min(max(nb, 0ll), 32ll * wn);
        }
        if (hb < 0 || hb > 32ll * kHdrWords) {
          err |= kHeaderOverflow;
          hb = min(max(hb, 0ll), 32ll * kHdrWords);
        }
        if (len < 0 || len > len_max) {
          err |= kBlockLength;
          len = min(max(len, 0ll), len_max);
        }
        s_mode[k] = (int)m;
        s_nb[k] = nb;
        s_hb[k] = hb;
        s_len[k] = len;
        f[h] = row_fn((int)m, nb, hb, len);
        stored[h] = m == 0 && len > 0;
      }
    }
    Fn inc = then(f[0], f[1]);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Fn o = shfl_up(inc, d);
      if (lane >= d) inc = then(o, inc);
    }
    Fn ex = shfl_up(inc, 1);
    if (lane == 0) ex = identity();
    const long long s0 = apply(ex, x0), s1 = apply(f[0], s0);
    if (2 * lane < rows) s_start[2 * lane] = s0;
    if (2 * lane + 1 < rows) s_start[2 * lane + 1] = s1;
    const Fn all = Fn{__shfl_sync(0xffffffffu, inc.k, 31),
                      __shfl_sync(0xffffffffu, inc.a, 31),
                      __shfl_sync(0xffffffffu, inc.b, 31)};
    const long long end = apply(all, x0);
    if (lane == 0) s_start[rows] = end;
    // The first stored row with a byte: the bit past its block bits.
    const unsigned b0 = __ballot_sync(0xffffffffu, stored[0]);
    const unsigned b1 = __ballot_sync(0xffffffffu, stored[1]);
    int first = 2 * kMaxRows;
    if (b0) first = 2 * (__ffs(b0) - 1);
    if (b1) first = min(first, 2 * (__ffs(b1) - 1) + 1);
    const long long sf = __shfl_sync(0xffffffffu, (first & 1) ? s1 : s0,
                                     (first >> 1) & 31);
    err = (long long)__reduce_or_sync(0xffffffffu, (unsigned)err);
    if (lane == 0 && blockIdx.x == 0 && blockIdx.y == 0) {
      if (end > 32 * cap_words) err |= kCapacity;
      long long* out = a.state + 4ll * (group + 1);
      out[0] = end & 7;
      out[1] = end - x0;
      out[2] = first < rows ? sf + 3 : -1;
      out[3] = err;
    }
  }
  __syncthreads();

  const Rows r{s_start, s_mode, s_nb, s_hb, s_len, a, rows, wn, last,
               raw_stride, raw_offset};
  const int j = (int)blockIdx.x;
  const long long s = s_start[j], e = s_start[j + 1];
  const long long w_lo = j == 0 ? 0 : ceil32(s), w_hi = ceil32(e);
  const long long first_id = (long long)blockIdx.y * kThreads + tid;
  const long long step = (long long)kSplit * kThreads;
  uint32_t* piece = a.piece;
  // The payload's interior words [fast_lo, fast_lo + fast_n).
  long long fast_lo = w_hi, fast_n = 0;
  if (s_mode[j] != 0) {
    const long long p = s + 3 + s_hb[j], nb = s_nb[j];
    fast_lo = ceil32(p);
    const int sh = (int)(32 * fast_lo - p);
    fast_n = nb >= sh ? (nb - sh) >> 5 : 0;
    const uint32_t* pw = a.words + (long long)j * wn;
    const bool vec = (reinterpret_cast<uintptr_t>(pw) & 15u) == 0;
    const long long nvec = (fast_n + 3) >> 2;
    // Every thread of the CTA takes each round, for the shuffle.
    for (long long v0 = (long long)blockIdx.y * kThreads; v0 < nvec;
         v0 += step) {
      const long long v = v0 + tid, q = 4 * v;
      uint32_t w4[5] = {0u, 0u, 0u, 0u, 0u};
      // One vector past the last, for the fifth word of the one before.
      if (v <= nvec && q < wn) {
        if (vec && q + 4 <= wn) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(pw + q));
          w4[0] = u.x;
          w4[1] = u.y;
          w4[2] = u.z;
          w4[3] = u.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (q + k < wn) w4[k] = __ldg(pw + q + k);
        }
      }
      uint32_t next = __shfl_down_sync(0xffffffffu, w4[0], 1);
      if (lane == 31) next = (v < nvec && q + 4 < wn) ? __ldg(pw + q + 4) : 0u;
      w4[4] = next;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long w = fast_lo + q + k;
        if (q + k < fast_n && w < cap_words)
          piece[w] = __funnelshift_r(w4[k], w4[k + 1], sh);
      }
    }
  }
  // The rest of the row's words, gathered.
  const long long n1 = fast_lo - w_lo, lo2 = fast_lo + fast_n;
  const long long total = n1 + (w_hi - lo2);
  for (long long i = first_id; i < total; i += step) {
    const long long w = i < n1 ? w_lo + i : lo2 + (i - n1);
    if (w < cap_words) piece[w] = r.word(w, j);
  }
}

}  // namespace

extern "C" {

// One K10 launch: rows x kSplit CTAs of kThreads threads join the rows of
// args' group (every pointer a contiguous device buffer: words wn int32 a
// row, hdr_words kHdrWords a row, raw raw_stride bytes a row with the block
// at raw_offset) into args' piece (cap_words uint32 words), reading the
// start phase from state row `group` and writing state row group + 1.
// `last` is the row of the stream's last block, -1 if the group has none.
// rows must lie in 1..kMaxRows.
int zt_join_rows(const JoinArgs* args, int rows, int wn,
                 long long raw_stride, long long raw_offset,
                 long long block_size, int last, int group,
                 long long cap_words, void* stream, int device) {
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  join_rows_kernel<<<dim3(rows, kSplit), kThreads, 0,
                     (cudaStream_t)stream>>>(*args, rows, wn, raw_stride,
                                             raw_offset, block_size, last,
                                             group, cap_words);
  return (int)cudaGetLastError();
}

}  // extern "C"

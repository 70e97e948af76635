// zippy_tpu_torch's host codec: DEFLATE encode and decode, the gzip and zlib
// containers and the checksums on the host CPU, and the device decode's
// host scan. It is the port's own copy of zippy_tpu's native runtime
// (zippy_tpu/native/src/zippy_native.cpp). Its code is the reference's
// apart from the <cstdio> and <memory> includes below (the reference relies
// on its other headers to declare fprintf and std::unique_ptr, and GCC 13's
// do not declare fprintf) and the scan's match loop, which folds the adler32
// reduction and the segment's depth once per match instead of once per
// byte (the same outputs); its comments speak of the port where the
// reference's speak of the TPU. Its bytes decide the host engine's streams,
// which the tests hold byte-identical to the reference's.
//
// Behavior parity targets (NOT a translation — the design here is a
// two-level LUT + canonical-fallback decoder and a package-merge length
// limiter, neither of which zippy uses):
//   inflate:  zippy's src/zippy/inflate.nim
//   deflate:  zippy's src/zippy/deflate.nim, lz77.nim, snappy.nim
//   bit IO:   zippy's src/zippy/bitstreams.nim
//   checksums:zippy's src/zippy/crc.nim, adler32.nim
//
// Exported C ABI (ctypes, zippy_tpu_torch/native.py): see block at the bottom.

#include <cstdio>
#include <memory>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <functional>
#include <deque>
#include <atomic>
#include <chrono>

namespace {

// ---------------------------------------------------------------------------
// Checksums
// ---------------------------------------------------------------------------

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t b = 0; b < 256; b++) {
      uint32_t c = b;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ ((c & 1) ? 0xEDB88320u : 0);
      t[0][b] = c;
    }
    for (int s = 1; s < 8; s++)
      for (uint32_t b = 0; b < 256; b++)
        t[s][b] = (t[s - 1][b] >> 8) ^ t[0][t[s - 1][b] & 0xFF];
  }
};
const CrcTables kCrc;

uint32_t crc32_sliceby8(const uint8_t* p, size_t n, uint32_t c) {
  // Slice-by-8: process 8 bytes per step, 8 independent table lookups.
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^
        kCrc.t[5][(lo >> 16) & 0xFF] ^ kCrc.t[4][lo >> 24] ^
        kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
        kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ kCrc.t[0][(c ^ *p++) & 0xFF];
  return c;
}

#if defined(__PCLMUL__) && defined(__SSE4_1__)
#include <immintrin.h>
#define ZT_HAVE_PCLMUL 1
// PCLMULQDQ 4x128-bit folding CRC-32 (same algebra as the reference's
// crc32_sse41_pcmul, crc32_simd.nim:39-144 — reimplemented from the
// standard reflected-fold construction, constants for poly 0xEDB88320).
uint32_t crc32_pclmul(const uint8_t* p, size_t n, uint32_t c) {
  const __m128i k1k2 = _mm_set_epi64x(0x1c6e41596, 0x154442bd4);
  const __m128i k3k4 = _mm_set_epi64x(0x0ccaa009e, 0x1751997d0);
  const __m128i k5 = _mm_set_epi64x(0, 0x163cd6124);
  const __m128i barrett = _mm_set_epi64x(0x1db710641, 0x1f7011641);
  __m128i x0 = _mm_loadu_si128((const __m128i*)p);
  __m128i x1 = _mm_loadu_si128((const __m128i*)(p + 16));
  __m128i x2 = _mm_loadu_si128((const __m128i*)(p + 32));
  __m128i x3 = _mm_loadu_si128((const __m128i*)(p + 48));
  x0 = _mm_xor_si128(x0, _mm_cvtsi32_si128((int)c));
  p += 64;
  n -= 64;
  while (n >= 64) {
    x0 = _mm_xor_si128(
        _mm_xor_si128(_mm_clmulepi64_si128(x0, k1k2, 0x00),
                      _mm_clmulepi64_si128(x0, k1k2, 0x11)),
        _mm_loadu_si128((const __m128i*)p));
    x1 = _mm_xor_si128(
        _mm_xor_si128(_mm_clmulepi64_si128(x1, k1k2, 0x00),
                      _mm_clmulepi64_si128(x1, k1k2, 0x11)),
        _mm_loadu_si128((const __m128i*)(p + 16)));
    x2 = _mm_xor_si128(
        _mm_xor_si128(_mm_clmulepi64_si128(x2, k1k2, 0x00),
                      _mm_clmulepi64_si128(x2, k1k2, 0x11)),
        _mm_loadu_si128((const __m128i*)(p + 32)));
    x3 = _mm_xor_si128(
        _mm_xor_si128(_mm_clmulepi64_si128(x3, k1k2, 0x00),
                      _mm_clmulepi64_si128(x3, k1k2, 0x11)),
        _mm_loadu_si128((const __m128i*)(p + 48)));
    p += 64;
    n -= 64;
  }
  // Fold 4 lanes into 1 (128 bits) with k3k4.
  __m128i x = _mm_xor_si128(
      _mm_xor_si128(_mm_clmulepi64_si128(x0, k3k4, 0x00),
                    _mm_clmulepi64_si128(x0, k3k4, 0x11)), x1);
  x = _mm_xor_si128(
      _mm_xor_si128(_mm_clmulepi64_si128(x, k3k4, 0x00),
                    _mm_clmulepi64_si128(x, k3k4, 0x11)), x2);
  x = _mm_xor_si128(
      _mm_xor_si128(_mm_clmulepi64_si128(x, k3k4, 0x00),
                    _mm_clmulepi64_si128(x, k3k4, 0x11)), x3);
  while (n >= 16) {
    x = _mm_xor_si128(
        _mm_xor_si128(_mm_clmulepi64_si128(x, k3k4, 0x00),
                      _mm_clmulepi64_si128(x, k3k4, 0x11)),
        _mm_loadu_si128((const __m128i*)p));
    p += 16;
    n -= 16;
  }
  // 128 -> 64: fold high half onto low with k4, then k5.
  x = _mm_xor_si128(_mm_clmulepi64_si128(x, k3k4, 0x10),
                    _mm_srli_si128(x, 8));
  x = _mm_xor_si128(_mm_clmulepi64_si128(_mm_and_si128(x, _mm_set_epi64x(0, ~0ULL >> 32)), k5, 0x00),
                    _mm_srli_si128(x, 4));
  // Barrett reduction 64 -> 32.
  __m128i t = _mm_clmulepi64_si128(
      _mm_and_si128(x, _mm_set_epi64x(0, 0xFFFFFFFF)), barrett, 0x00);
  t = _mm_clmulepi64_si128(
      _mm_and_si128(t, _mm_set_epi64x(0, 0xFFFFFFFF)), barrett, 0x10);
  x = _mm_xor_si128(x, t);
  c = (uint32_t)_mm_extract_epi32(x, 1);
  return crc32_sliceby8(p, n, c);  // tail < 16 bytes
}
#endif

uint32_t crc32(const uint8_t* p, size_t n, uint32_t crc = 0) {
  uint32_t c = ~crc;
#ifdef ZT_HAVE_PCLMUL
  if (n >= 64) return ~crc32_pclmul(p, n, c);
#endif
  return ~crc32_sliceby8(p, n, c);
}

#if defined(__AVX2__)
#define ZT_HAVE_AVX2_ADLER 1
#include <immintrin.h>
#endif

uint32_t adler32(const uint8_t* p, size_t n, uint32_t adler = 1) {
  const uint32_t MOD = 65521;
  uint32_t s1 = adler & 0xFFFF, s2 = adler >> 16;
  // NMAX = largest n with 255n(n+1)/2 + (n+1)(MOD-1) < 2^32 (zlib's trick).
  const size_t NMAX = 5552;
#ifdef ZT_HAVE_AVX2_ADLER
  // 32 bytes per step (maddubs weighted sums + sad byte sums), one
  // horizontal reduction per NMAX window. Same math as the reference's
  // adler32_ssse3 (adler32_simd.nim:45-96), AVX2-width.
  if (n >= 64) {
    const __m256i w = _mm256_setr_epi8(
        32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
        16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1);
    const __m256i ones16 = _mm256_set1_epi16(1);
    const __m256i zero = _mm256_setzero_si256();
    while (n >= 32) {
      size_t m = (n < NMAX ? n : NMAX) / 32;   // chunks this window
      __m256i vsad = zero;    // 4x64 running byte sums
      __m256i vcarry = zero;  // 4x64 sum over chunks of prior vsad
      __m256i vw = zero;      // 8x32 weighted sums
      uint32_t s1_0 = s1;
      for (size_t j = 0; j < m; j++) {
        __m256i c = _mm256_loadu_si256((const __m256i*)(p + 32 * j));
        vcarry = _mm256_add_epi64(vcarry, vsad);
        vsad = _mm256_add_epi64(vsad, _mm256_sad_epu8(c, zero));
        vw = _mm256_add_epi32(
            vw, _mm256_madd_epi16(_mm256_maddubs_epi16(c, w), ones16));
      }
      uint64_t sad_arr[4], carry_arr[4];
      uint32_t w_arr[8];
      _mm256_storeu_si256((__m256i*)sad_arr, vsad);
      _mm256_storeu_si256((__m256i*)carry_arr, vcarry);
      _mm256_storeu_si256((__m256i*)w_arr, vw);
      uint32_t S = (uint32_t)(sad_arr[0] + sad_arr[1] + sad_arr[2] + sad_arr[3]);
      uint32_t C = (uint32_t)(carry_arr[0] + carry_arr[1] + carry_arr[2] +
                              carry_arr[3]);
      uint32_t W = 0;
      for (int i = 0; i < 8; i++) W += w_arr[i];
      s1 = (s1_0 + S) % MOD;
      s2 = (uint32_t)(((uint64_t)s2 + (uint64_t)32 * m % MOD * s1_0 +
                       (uint64_t)32 * (C % MOD) + W) % MOD);
      p += 32 * m;
      n -= 32 * m;
    }
  }
#endif
  while (n) {
    size_t k = n < NMAX ? n : NMAX;
    n -= k;
    while (k >= 16) {
      for (int i = 0; i < 16; i++) { s1 += p[i]; s2 += s1; }
      p += 16;
      k -= 16;
    }
    while (k--) { s1 += *p++; s2 += s1; }
    s1 %= MOD;
    s2 %= MOD;
  }
  return (s2 << 16) | s1;
}

// ---------------------------------------------------------------------------
// RFC 1951 constant tables
// ---------------------------------------------------------------------------

const uint16_t kBaseLengths[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                   15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                   67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLengthExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint32_t kBaseDists[30] = {1,    2,    3,    4,    5,    7,    9,   13,
                                 17,   25,   33,   49,   65,   97,   129, 193,
                                 257,  385,  513,  769,  1025, 1537, 2049, 3073,
                                 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const uint8_t kClclOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                11, 4, 12, 3, 13, 2, 14, 1, 15};

const int kMinMatch = 4;       // hash/insert granularity (4-byte reads); the
                               // chain matcher emits length-3 matches when
                               // dist <= 4096 (zlib TOO_FAR rule)
const int kMaxMatch = 258;
const int kWindow = 32768;
const size_t kMaxBlock = 4u << 20;      // 4 MiB encoder block seam
const size_t kMaxStored = 65535;

// length (3..258) -> length code index 0..28
struct LenCodeLut {
  uint8_t idx[256];
  LenCodeLut() {
    for (int c = 0; c < 29; c++) {
      int span = 1 << kLengthExtra[c];
      for (int l = kBaseLengths[c]; l < kBaseLengths[c] + span && l <= 258; l++)
        idx[l - 3] = (uint8_t)c;
    }
    idx[255] = 28;  // length 258
  }
};
const LenCodeLut kLenCode;

// distance (1..32768) -> distance code index 0..29 (two-level like zlib d_code)
struct DistCodeLut {
  uint8_t lo[256], hi[256];
  DistCodeLut() {
    for (int c = 0; c < 30; c++) {
      uint32_t end = kBaseDists[c] + (1u << kDistExtra[c]);
      for (uint32_t d = kBaseDists[c]; d < end && d <= 256; d++) lo[d - 1] = (uint8_t)c;
      for (uint32_t d = std::max<uint32_t>(kBaseDists[c], 257); d < end && d <= 32768; d++)
        hi[(d - 1) >> 7] = (uint8_t)c;
    }
  }
  inline int code(uint32_t dist) const {
    return dist <= 256 ? lo[dist - 1] : hi[(dist - 1) >> 7];
  }
};
const DistCodeLut kDistCode;

// ---------------------------------------------------------------------------
// Bit reader (LSB-first, 64-bit buffer)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* src;
  size_t len;
  size_t byte_pos;   // next byte to load (may run past len, loading zeros)
  uint64_t buf = 0;
  int cnt = 0;       // bits in buf

  BitReader(const uint8_t* s, size_t n, size_t start_bit)
      : src(s), len(n), byte_pos(start_bit >> 3) {
    int sub = (int)(start_bit & 7);
    if (sub) {
      buf = (byte_pos < len ? src[byte_pos] : 0) >> sub;
      cnt = 8 - sub;
      byte_pos++;
    }
  }

  inline void refill() {
    if (byte_pos + 8 <= len) {
      uint64_t w;
      memcpy(&w, src + byte_pos, 8);
      buf |= w << cnt;
      int add = (63 - cnt) & ~7;
      byte_pos += add >> 3;
      cnt += add;
    } else {
      while (cnt <= 56) {
        buf |= (uint64_t)(byte_pos < len ? src[byte_pos] : 0) << cnt;
        byte_pos++;
        cnt += 8;
      }
    }
  }

  inline uint32_t peek(int n) {
    if (cnt < n) refill();
    return (uint32_t)(buf & ((1u << n) - 1));
  }
  inline void drop(int n) { buf >>= n; cnt -= n; }
  inline uint32_t bits(int n) {
    uint32_t v = peek(n);
    drop(n);
    return v;
  }
  // Total bits consumed so far (counting fictitious zero bytes past the end).
  inline size_t consumed() const { return byte_pos * 8 - (size_t)cnt; }
  inline bool overrun() const { return consumed() > len * 8; }
  inline void align_byte() { drop(cnt & 7); }
};

// ---------------------------------------------------------------------------
// Huffman decode: 10-bit LUT fast path + canonical bit-by-bit fallback
// ---------------------------------------------------------------------------

const int kLutBits = 10;
const uint32_t kLutMask = (1u << kLutBits) - 1;

// Packed 32-bit LUT entry flags (fast symbol loop; see build_packed).
const uint32_t kPkLit = 1u << 4;
const uint32_t kPkEob = 1u << 5;
const uint32_t kPkBad = 1u << 6;
const uint32_t kPkPair = 1u << 7;  // entry resolves TWO literals

struct HuffDecoder {
  uint16_t lut[1 << kLutBits];  // (sym << 4) | code_len; 0 = slow path
  uint32_t lut32[1 << kLutBits];  // packed entries (litlen/dist kinds)
  uint16_t first_code[16];      // canonical MSB-first first code per length
  uint16_t limit[16];           // first_code + count
  uint16_t offset[16];          // index of first symbol of this length
  uint16_t sorted_syms[288];
  int num_codes = 0;

  // Returns false on an over-subscribed code. Incomplete codes are accepted
  // at build time; hitting an unassigned code during decode errors instead
  // (mirrors the reference's in-band bad-code sentinel, inflate.nim:77-82).
  bool build(const uint8_t* lens, int n) {
    memset(lut, 0, sizeof(lut));
    uint16_t count[16] = {0};
    for (int i = 0; i < n; i++) count[lens[i]]++;
    count[0] = 0;
    uint32_t total = 0;
    uint32_t code = 0;
    uint16_t next_idx[16];
    num_codes = 0;
    for (int l = 1; l <= 15; l++) {
      code = (code + count[l - 1]) << 1;
      first_code[l] = (uint16_t)code;
      limit[l] = (uint16_t)(code + count[l]);
      offset[l] = (uint16_t)num_codes;
      next_idx[l] = (uint16_t)num_codes;
      num_codes += count[l];
      total += (uint32_t)count[l] << (15 - l);
      if (total > 32768u) return false;  // over-subscribed
    }
    uint16_t next_code[16];
    for (int l = 1; l <= 15; l++) next_code[l] = first_code[l];
    for (int sym = 0; sym < n; sym++) {
      int l = lens[sym];
      if (!l) continue;
      uint32_t c = next_code[l]++;
      sorted_syms[next_idx[l]++] = (uint16_t)sym;
      if (l <= kLutBits) {
        // reverse the l-bit code (stream is LSB-first, codes packed MSB-first)
        uint32_t r = 0;
        for (int b = 0; b < l; b++) r |= ((c >> b) & 1) << (l - 1 - b);
        for (uint32_t i = r; i < (1u << kLutBits); i += 1u << l)
          lut[i] = (uint16_t)((sym << 4) | l);
      }
    }
    return true;
  }

  // Fill lut32 with self-contained entries so the hot loop needs ONE lookup
  // per symbol. Layout: bits 0-3 total code length (0 = slow/long code);
  //   litlen kind: bit4 literal (byte at 8-15), bit5 EOB, bit6 invalid,
  //                bit7 literal PAIR (byte0 at 8-15, byte1 at 16-23, len =
  //                both codes fused — one lookup emits two bytes),
  //                length syms: base at 16-24, extra-bit count at 28-30
  //   dist kind:   extra-bit count at 8-11, base at 16-31
  void build_packed(bool is_litlen) {
    for (uint32_t i = 0; i < (1u << kLutBits); i++) {
      uint16_t e = lut[i];
      if (!e) {
        lut32[i] = 0;
        continue;
      }
      uint32_t len = e & 15;
      uint32_t sym = e >> 4;
      uint32_t v;
      if (is_litlen) {
        if (sym < 256) {
          v = len | kPkLit | (sym << 8);
          // Double-literal fusion: if the FULL second code (it must also be
          // a literal) fits in the remaining window bits, resolve both in
          // one entry. Default-level text streams carry 5-8 bit literal
          // codes, so most literal chains halve; streams whose codes never
          // pair (e.g. 8-9 bit BestSpeed codes under a 10-bit LUT) hit the
          // single-literal path exactly as before.
          // `i >> len` zero-extends the unknown high bits; a stored code of
          // length l2 <= kLutBits-len is fully determined by the known low
          // bits (prefix-freeness), so the entry read here is authoritative
          // exactly when the fusion condition below holds.
          uint16_t e2 = lut[i >> len];
          uint32_t l2 = e2 & 15;
          uint32_t sym2 = e2 >> 4;
          if (e2 && sym2 < 256 && len + l2 <= (uint32_t)kLutBits) {
            v = (len + l2) | kPkLit | kPkPair | (sym << 8) | (sym2 << 16);
          }
        } else if (sym == 256) {
          v = len | kPkEob;
        } else if (sym <= 285) {
          uint32_t li = sym - 257;
          v = len | ((uint32_t)kBaseLengths[li] << 16)
              | ((uint32_t)kLengthExtra[li] << 28);
        } else {
          v = len | kPkBad;
        }
      } else {
        if (sym <= 29) {
          v = len | ((uint32_t)kDistExtra[sym] << 8) | (kBaseDists[sym] << 16);
        } else {
          v = len | kPkBad;
        }
      }
      lut32[i] = v;
    }
  }

  // Returns symbol or -1 on invalid code.
  inline int decode(BitReader& br) const {
    uint32_t window = br.peek(15);
    uint16_t e = lut[window & ((1 << kLutBits) - 1)];
    if (e) {
      br.drop(e & 15);
      return e >> 4;
    }
    uint32_t code = 0;
    for (int l = 1; l <= 15; l++) {
      code = (code << 1) | (window & 1);
      window >>= 1;
      if (code >= first_code[l] && code < limit[l]) {
        br.drop(l);
        return sorted_syms[offset[l] + (code - first_code[l])];
      }
    }
    return -1;
  }
};

struct FixedTables {
  HuffDecoder litlen, dist;
  FixedTables() {
    uint8_t ll[288], dd[30];
    for (int i = 0; i < 144; i++) ll[i] = 8;
    for (int i = 144; i < 256; i++) ll[i] = 9;
    for (int i = 256; i < 280; i++) ll[i] = 7;
    for (int i = 280; i < 288; i++) ll[i] = 8;
    for (int i = 0; i < 30; i++) dd[i] = 5;
    litlen.build(ll, 288);
    litlen.build_packed(true);
    dist.build(dd, 30);
    dist.build_packed(false);
  }
};
const FixedTables kFixed;

// ---------------------------------------------------------------------------
// Inflate
// ---------------------------------------------------------------------------

enum {
  ZT_OK = 0,
  ZT_ERR_MALFORMED = -1,
  ZT_ERR_DST_FULL = -2,
};

// Inflate one complete deflate stream. Returns bytes written (>= 0) or error.
int64_t inflate_impl(const uint8_t* src, size_t src_len, size_t start_bit,
                     uint8_t* dst, size_t dst_cap, size_t* end_bit) {
  BitReader br(src, src_len, start_bit);
  size_t op = 0;
  bool final_block = false;
  HuffDecoder dyn_litlen, dyn_dist;

  while (!final_block) {
    if (br.overrun()) return ZT_ERR_MALFORMED;
    final_block = br.bits(1) != 0;
    uint32_t btype = br.bits(2);

    if (btype == 0) {  // stored
      br.align_byte();
      uint32_t len = br.bits(16);
      uint32_t nlen = br.bits(16);
      if ((len ^ nlen) != 0xFFFF) return ZT_ERR_MALFORMED;
      // Current byte position: buffered bits are whole bytes after align.
      size_t cur = br.byte_pos - (size_t)(br.cnt >> 3);
      if (cur + len > src_len) return ZT_ERR_MALFORMED;
      if (op + len > dst_cap) return ZT_ERR_DST_FULL;
      memcpy(dst + op, src + cur, len);
      op += len;
      br.byte_pos = cur + len;
      br.buf = 0;
      br.cnt = 0;
      continue;
    }
    if (btype == 3) return ZT_ERR_MALFORMED;

    const HuffDecoder* litlen = &kFixed.litlen;
    const HuffDecoder* dist = &kFixed.dist;
    if (btype == 2) {  // dynamic: rebuild tables from RLE'd code lengths
      uint32_t hlit = br.bits(5) + 257;
      uint32_t hdist = br.bits(5) + 1;
      uint32_t hclen = br.bits(4) + 4;
      if (hlit > 286 || hdist > 30) return ZT_ERR_MALFORMED;
      uint8_t cl_lens[19] = {0};
      for (uint32_t i = 0; i < hclen; i++) cl_lens[kClclOrder[i]] = (uint8_t)br.bits(3);
      HuffDecoder cl;
      if (!cl.build(cl_lens, 19)) return ZT_ERR_MALFORMED;
      uint8_t lens[286 + 30] = {0};
      uint32_t total = hlit + hdist;
      uint32_t i = 0;
      while (i < total) {
        if (br.overrun()) return ZT_ERR_MALFORMED;
        int sym = cl.decode(br);
        if (sym < 0) return ZT_ERR_MALFORMED;
        if (sym < 16) {
          lens[i++] = (uint8_t)sym;
        } else if (sym == 16) {
          if (i == 0) return ZT_ERR_MALFORMED;
          uint32_t rep = 3 + br.bits(2);
          if (i + rep > total) return ZT_ERR_MALFORMED;
          uint8_t v = lens[i - 1];
          while (rep--) lens[i++] = v;
        } else if (sym == 17) {
          uint32_t rep = 3 + br.bits(3);
          if (i + rep > total) return ZT_ERR_MALFORMED;
          i += rep;
        } else {
          uint32_t rep = 11 + br.bits(7);
          if (i + rep > total) return ZT_ERR_MALFORMED;
          i += rep;
        }
      }
      if (lens[256] == 0) return ZT_ERR_MALFORMED;  // EOB must be codable
      if (!dyn_litlen.build(lens, (int)hlit)) return ZT_ERR_MALFORMED;
      if (!dyn_dist.build(lens + hlit, (int)hdist)) return ZT_ERR_MALFORMED;
      dyn_litlen.build_packed(true);
      dyn_dist.build_packed(false);
      litlen = &dyn_litlen;
      dist = &dyn_dist;
    }

    // Symbol loop. Fast path: one unconditional refill guarantees >= 56
    // buffered bits; literals then decode in a run while >= 15 bits remain
    // buffered (enough for any code the 10-bit LUT resolves plus the next
    // lookup), so typical text streams (5-9 bit literal codes) emit 6-10
    // literals per refill. A match header consumes at most 15+5 bits before
    // the distance, whose 15+13 worst case is covered by a conditional
    // refill. Destination writes keep 300 bytes of slack so match copies go
    // unchecked; because a literal run (1-bit codes, fused pairs) can emit
    // up to ~84 bytes per refill, the slack is re-checked between the run
    // and the match decode so the unchecked <=273-byte copy (258 + 15-byte
    // stride overrun) never starts with less than 300 bytes remaining. The
    // careful loop below handles the tail and tight buffers.
    const size_t src_bits = src_len * 8;
    bool eob = false;
    while (!eob && op + 300 <= dst_cap) {
      br.refill();
      if (br.consumed() > src_bits + 64) return ZT_ERR_MALFORMED;
      // Packed-LUT decode: one 32-bit entry carries literal byte or length
      // base + extra-bit count, so the common paths touch no other tables.
      uint32_t e = litlen->lut32[br.buf & kLutMask];
      while (e & kPkLit) {
        // Pair entries carry two fused literals (byte0|byte1 little-endian
        // at bits 8-23); writing 2 bytes and advancing by the pair flag
        // keeps this branchless for both kinds.
        uint16_t two = (uint16_t)(e >> 8);
        memcpy(dst + op, &two, 2);
        op += 1 + ((e >> 7) & 1);
        br.drop(e & 15);
        if (br.cnt < 15) break;
        e = litlen->lut32[br.buf & kLutMask];
      }
      if (e & kPkLit) continue;  // run ended on low bits; refill and resume
      // Literal run may have consumed the slack; the pending (undropped)
      // code re-decodes cleanly in the careful loop.
      if (op + 300 > dst_cap) break;
      uint32_t length;
      if (e & 15) {
        if (e & kPkEob) {
          br.drop(e & 15);
          eob = true;
          break;
        }
        if (e & kPkBad) return ZT_ERR_MALFORMED;
        // One fused drop for code + extra bits.
        uint32_t cl = e & 15;
        uint32_t ebits = e >> 28;
        length = ((e >> 16) & 0x1FF)
                 + (uint32_t)((br.buf >> cl) & ((1u << ebits) - 1));
        br.drop((int)(cl + ebits));
      } else {
        // Long code (> kLutBits): canonical slow path.
        int sym = litlen->decode(br);
        if (sym < 0 || sym > 285) return ZT_ERR_MALFORMED;
        if (sym < 256) {
          dst[op++] = (uint8_t)sym;
          continue;
        }
        if (sym == 256) {
          eob = true;
          break;
        }
        uint32_t li = sym - 257;
        length = kBaseLengths[li] + br.bits(kLengthExtra[li]);
      }
      if (br.cnt < 28) br.refill();  // dist code (<=15) + extra (<=13)
      uint32_t de = dist->lut32[br.buf & kLutMask];
      uint32_t distance;
      if (de & 15) {
        if (de & kPkBad) return ZT_ERR_MALFORMED;
        uint32_t dcl = de & 15;
        uint32_t dbits = (de >> 8) & 15;
        distance = (de >> 16) + (uint32_t)((br.buf >> dcl) & ((1u << dbits) - 1));
        br.drop((int)(dcl + dbits));
      } else {
        int dsym = dist->decode(br);
        if (dsym < 0 || dsym > 29) return ZT_ERR_MALFORMED;
        distance = kBaseDists[dsym] + br.bits(kDistExtra[dsym]);
      }
      if (distance > op) return ZT_ERR_MALFORMED;
      uint8_t* d = dst + op;
      const uint8_t* s = d - distance;
      op += length;
      if (distance >= 16) {
        // Overlap-safe 16-byte strided copy; slack absorbs the <=15 overrun.
        size_t l = length;
        do {
          memcpy(d, s, 16);
          d += 16;
          s += 16;
        } while (l > 16 && (l -= 16));
      } else if (distance == 1) {
        memset(d, s[0], length);
      } else {
        // Short distances: double the materialized pattern until 16-byte
        // strides are overlap-safe (libdeflate-style), then copy wide.
        size_t l = length;
        while (distance < 16 && l > distance) {
          for (uint32_t k2 = 0; k2 < distance; k2++) d[k2] = s[k2];
          d += distance;
          l -= distance;
          distance *= 2;
        }
        while (l > 16) {
          memcpy(d, s, 16);
          d += 16;
          s += 16;
          l -= 16;
        }
        for (uint32_t k2 = 0; k2 < (uint32_t)l; k2++) d[k2] = s[k2];
      }
    }

    // Careful tail loop (bounds-checked per symbol).
    while (!eob) {
      if (br.overrun()) return ZT_ERR_MALFORMED;
      int sym = litlen->decode(br);
      if (sym < 0) return ZT_ERR_MALFORMED;
      if (sym < 256) {
        if (op >= dst_cap) return ZT_ERR_DST_FULL;
        dst[op++] = (uint8_t)sym;
        continue;
      }
      if (sym == 256) break;
      if (sym > 285) return ZT_ERR_MALFORMED;
      uint32_t li = sym - 257;
      uint32_t length = kBaseLengths[li] + br.bits(kLengthExtra[li]);
      int dsym = dist->decode(br);
      if (dsym < 0 || dsym > 29) return ZT_ERR_MALFORMED;
      uint32_t distance = kBaseDists[dsym] + br.bits(kDistExtra[dsym]);
      if (distance > op) return ZT_ERR_MALFORMED;
      if (op + length > dst_cap) return ZT_ERR_DST_FULL;
      uint8_t* d = dst + op;
      const uint8_t* s = d - distance;
      op += length;
      for (uint32_t k = 0; k < length; k++) d[k] = s[k];
    }
  }
  if (br.overrun()) return ZT_ERR_MALFORMED;
  // consumed() is absolute (the constructor pre-counts start_bit).
  if (end_bit) *end_bit = br.consumed();
  return (int64_t)op;
}

// ---------------------------------------------------------------------------
// Bit writer (LSB-first, 64-bit accumulator)
// ---------------------------------------------------------------------------

struct BitWriter {
  uint8_t* dst;
  size_t cap;
  size_t pos = 0;    // bytes fully written
  uint64_t buf = 0;
  int cnt = 0;
  bool full = false;

  BitWriter(uint8_t* d, size_t c) : dst(d), cap(c) {}

  inline void add(uint32_t v, int n) {  // n <= 32, v < 2^n
    buf |= (uint64_t)v << cnt;
    cnt += n;
    if (cnt >= 32) {
      if (pos + 4 <= cap) {
        uint32_t w = (uint32_t)buf;
        memcpy(dst + pos, &w, 4);
      } else {
        full = true;
      }
      pos += 4;
      buf >>= 32;
      cnt -= 32;
    }
  }
  void align_byte() {
    if (cnt & 7) add(0, 8 - (cnt & 7));
  }
  int bit_pos_in_byte() const { return cnt & 7; }  // pos is whole bytes
  // Flush remaining whole bytes; returns final size in bytes.
  size_t finish() {
    align_byte();
    while (cnt >= 8) {
      if (pos < cap)
        dst[pos] = (uint8_t)buf;
      else
        full = true;
      pos++;
      buf >>= 8;
      cnt -= 8;
    }
    return pos;
  }
  void write_bytes(const uint8_t* p, size_t n) {  // requires byte alignment
    if (pos + n <= cap)
      memcpy(dst + pos, p, n);
    else
      full = true;
    pos += n;
  }
  // Flush ALL buffered bits (memory is zero-padded to a byte boundary but
  // the returned count is exact). For splicing non-final sub-streams.
  size_t finish_bits() {
    size_t nbits = pos * 8 + (size_t)cnt;
    while (cnt > 0) {
      if (pos < cap)
        dst[pos] = (uint8_t)buf;
      else
        full = true;
      pos++;
      buf >>= 8;
      cnt -= 8;
    }
    cnt = 0;
    buf = 0;
    return nbits;
  }
  // Append nbits of an LSB-first bit stream at the current (arbitrary)
  // bit position. Used to join per-thread deflate sub-streams.
  void append_stream(const uint8_t* p, size_t nbits) {
    size_t i = 0;
    while (nbits >= 32) {
      uint32_t w;
      memcpy(&w, p + i, 4);
      add(w, 32);
      i += 4;
      nbits -= 32;
    }
    while (nbits >= 8) {
      add(p[i++], 8);
      nbits -= 8;
    }
    if (nbits) add(p[i] & ((1u << nbits) - 1), (int)nbits);
  }
};

// ---------------------------------------------------------------------------
// Length-limited Huffman code construction (package-merge; optimal under the
// limit, unlike heuristic rebalancing — reference deflate.nim:87-101 uses a
// histogram-rebalance loop instead).
// ---------------------------------------------------------------------------

// Plain Huffman code lengths via an array heap; returns the max depth.
// When the unconstrained optimum fits the length limit (the common case),
// it IS the length-limited optimum, and this path is ~5x faster than
// package-merge.
int huffman_lengths_unlimited(const uint32_t* freq, const int* active, int na,
                              uint8_t* lens) {
  // Sorted two-queue Huffman build (O(n) after the sort): leaves ascend in
  // one queue, merged nodes ascend in the other, so the two global minima
  // are always at the queue fronts. ~2.5x faster than a binary heap at
  // n<=286, and this runs per exact-cost eval in the segmentation planner.
  struct WId {
    uint64_t w;  // (weight << 10) | creation order: deterministic ties
    int32_t id;
  };
  thread_local std::vector<WId> leaves2, internal;
  thread_local std::vector<int32_t> parent;
  leaves2.resize(na);
  internal.clear();
  internal.reserve(na);
  parent.assign(2 * na - 1, -1);
  for (int i = 0; i < na; i++)
    leaves2[i] = {((uint64_t)freq[active[i]] << 10) | (uint32_t)i, i};
  std::sort(leaves2.begin(), leaves2.end(),
            [](const WId& a, const WId& b) { return a.w < b.w; });
  size_t la = 0, ia = 0;
  int next_id = na;
  auto take_min = [&]() -> WId {
    if (ia < internal.size() &&
        (la >= leaves2.size() || internal[ia].w <= leaves2[la].w))
      return internal[ia++];
    return leaves2[la++];
  };
  for (int k = 0; k < na - 1; k++) {
    WId a = take_min();
    WId b = take_min();
    parent[a.id] = next_id;
    parent[b.id] = next_id;
    internal.push_back(
        {(((a.w >> 10) + (b.w >> 10)) << 10) | (uint32_t)next_id, next_id});
    next_id++;
  }
  // Depths: children are always created before parents; walk top-down.
  thread_local std::vector<uint8_t> depth;
  depth.assign(2 * na - 1, 0);
  int max_depth = 0;
  for (int i = 2 * na - 3; i >= 0; i--) {
    depth[i] = depth[parent[i]] + 1;
    if (i < na) {
      lens[active[i]] = depth[i];
      if (depth[i] > max_depth) max_depth = depth[i];
    }
  }
  return max_depth;
}

// Approximate length-limited lengths: unconstrained Huffman + zlib-style
// overflow repair (tree.c gen_bitlen). A few bits above the package-merge
// optimum in the overflow case — used for the segmentation planner's cost
// EVALUATIONS (both sides of every comparison share the bias), never for
// emitted plans. ~10x cheaper than package-merge on skewed histograms.
void build_code_lengths_approx(const uint32_t* freq, int n, int limit,
                               uint8_t* lens) {
  memset(lens, 0, n);
  int active[288];
  int na = 0;
  for (int i = 0; i < n; i++)
    if (freq[i]) active[na++] = i;
  if (na == 0) return;
  if (na == 1) {
    lens[active[0]] = 1;
    return;
  }
  if (huffman_lengths_unlimited(freq, active, na, lens) <= limit) return;
  // Clamp depths and repair the Kraft sum on the per-depth counts, then
  // re-assign lengths to symbols in descending-frequency order.
  int count[64] = {0};
  for (int i = 0; i < na; i++)
    count[std::min<int>(lens[active[i]], limit)]++;
  // overflow units: each depth-d>limit leaf clamped to limit over-fills
  // Kraft; repair zlib-style by demoting one leaf from the deepest
  // non-empty level < limit (splits its slot into two at level+1).
  long long kraft = 0;
  for (int l = 1; l <= limit; l++)
    kraft += (long long)count[l] << (limit - l);
  while (kraft > (1LL << limit)) {
    int bits = limit - 1;
    while (count[bits] == 0) bits--;
    count[bits]--;        // demote one leaf from depth `bits`...
    count[bits + 1] += 2; // ...to bits+1, pairing it with...
    count[limit]--;       // ...one leaf pulled up from the deepest level.
    kraft -= 1;  // -2^(limit-bits) + 2*2^(limit-bits-1) - 1 = -1 (scaled)
  }
  // Assign: sort active by frequency descending, shortest codes first.
  struct FS {
    uint32_t f;
    int sym;
  };
  FS order[288];
  for (int i = 0; i < na; i++) order[i] = {freq[active[i]], active[i]};
  std::sort(order, order + na,
            [](const FS& a, const FS& b) { return a.f > b.f; });
  int oi = 0;
  for (int l = 1; l <= limit && oi < na; l++)
    for (int k = 0; k < count[l] && oi < na; k++) lens[order[oi++].sym] = l;
}

void build_code_lengths(const uint32_t* freq, int n, int limit, uint8_t* lens) {
  memset(lens, 0, n);
  int active[288];
  int na = 0;
  for (int i = 0; i < n; i++)
    if (freq[i]) active[na++] = i;
  if (na == 0) return;
  if (na == 1) {
    lens[active[0]] = 1;
    return;
  }

  if (huffman_lengths_unlimited(freq, active, na, lens) <= limit) return;
  memset(lens, 0, n);  // overflow: fall through to exact package-merge

  // Items are int32 handles: negative = leaf (~sym), non-negative = index
  // into the package arena. Weights ride alongside in (w, item) pairs.
  // This keeps the package-merge inner loop allocation-free (the naive
  // formulation copies per-item symbol lists and is ~50x slower).
  struct Node {
    int32_t left, right;
  };
  using WItem = std::pair<uint64_t, int32_t>;
  // Thread-local scratch: this runs per block on the hot path; repeated
  // vector construction dominated the builder's cost for small inputs.
  thread_local std::vector<Node> arena;
  thread_local std::vector<WItem> leaves, merged, packages, next;
  arena.clear();
  arena.reserve((size_t)na * limit / 2);
  leaves.resize(na);
  for (int i = 0; i < na; i++)
    leaves[i] = {freq[active[i]], ~active[i]};
  std::sort(leaves.begin(), leaves.end());  // (w, item) pair order: determinism

  merged = leaves;
  for (int level = 1; level < limit; level++) {
    packages.clear();
    for (size_t i = 0; i + 1 < merged.size(); i += 2) {
      arena.push_back({merged[i].second, merged[i + 1].second});
      packages.push_back(
          {merged[i].first + merged[i + 1].first, (int32_t)arena.size() - 1});
    }
    next.clear();
    next.reserve(leaves.size() + packages.size());
    size_t a = 0, b = 0;
    while (a < leaves.size() || b < packages.size()) {
      if (b >= packages.size() ||
          (a < leaves.size() && leaves[a].first <= packages[b].first))
        next.push_back(leaves[a++]);
      else
        next.push_back(packages[b++]);
    }
    merged.swap(next);
  }
  packages.clear();
  next.clear();
  // Select the 2(n_active - 1) smallest items; each appearance of a symbol
  // bumps its code length by one. Package trees are at most `limit` deep.
  size_t take = 2 * ((size_t)na - 1);
  int32_t stack[64];
  for (size_t i = 0; i < take && i < merged.size(); i++) {
    int sp = 0;
    stack[sp++] = merged[i].second;
    while (sp) {
      int32_t it = stack[--sp];
      if (it < 0) {
        lens[~it]++;
      } else {
        stack[sp++] = arena[it].left;
        stack[sp++] = arena[it].right;
      }
    }
  }
}

// Canonical codes, bit-reversed for LSB-first emission (RFC 1951 §3.2.2).
void canonical_codes(const uint8_t* lens, int n, uint16_t* codes) {
  uint16_t count[16] = {0};
  for (int i = 0; i < n; i++) count[lens[i]]++;
  count[0] = 0;
  uint16_t next[16] = {0};
  uint32_t code = 0;
  for (int l = 1; l <= 15; l++) {
    code = (code + count[l - 1]) << 1;
    next[l] = (uint16_t)code;
  }
  for (int i = 0; i < n; i++) {
    int l = lens[i];
    if (!l) {
      codes[i] = 0;
      continue;
    }
    uint32_t c = next[l]++;
    uint32_t r = 0;
    for (int b = 0; b < l; b++) r |= ((c >> b) & 1) << (l - 1 - b);
    codes[i] = (uint16_t)r;
  }
}

// ---------------------------------------------------------------------------
// LZ77 tokenization: hash-chain greedy matcher (zlib-style work factors,
// reference internal.nim:177-189; match-all-position insertion like
// reference lz77.nim:121-126; skip-ahead probing at level 1 like
// reference snappy.nim:90).
// ---------------------------------------------------------------------------

struct LevelCfg {
  int good, lazy, nice, chain;
};
const LevelCfg kLevels[10] = {
    {0, 0, 0, 0},        // 0: stored (unused)
    {4, 4, 8, 4},        // 1
    {4, 5, 16, 8},       // 2
    {4, 6, 32, 32},      // 3
    {4, 4, 16, 16},      // 4
    {8, 16, 32, 32},     // 5
    {8, 16, 128, 128},   // 6
    {8, 32, 128, 256},   // 7
    {32, 128, 258, 1024},// 8
    {32, 258, 258, 4096},// 9
};

const int kHashBits = 16;

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 0x9E3779B1u) >> (32 - kHashBits);
}

inline uint16_t read16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

inline int match_len(const uint8_t* a, const uint8_t* b, int max) {
  int i = 0;
  while (i + 8 <= max) {
    uint64_t x, y;
    memcpy(&x, a + i, 8);
    memcpy(&y, b + i, 8);
    uint64_t diff = x ^ y;
    if (diff) return i + (__builtin_ctzll(diff) >> 3);
    i += 8;
  }
  while (i < max && a[i] == b[i]) i++;
  return i;
}

// Token: high bit set => match: (1<<31) | (len-3)<<16 | (dist-1).
// Otherwise: literal run length (bytes copied verbatim from the cursor).
struct TokenStream {
  std::vector<uint32_t> tokens;
  uint32_t lit_freq[286] = {0};   // litlen symbol frequencies (includes EOB)
  uint32_t dist_freq[30] = {0};
  size_t n_literals = 0;          // total literal bytes
  size_t n_tokens_match = 0;
  // Match bytes per 32 KiB window of the tokenized region (filled by
  // tokenize_fast): the level-1 segmentation trigger reads the density
  // spread without an extra pass.
  std::vector<uint32_t> match_bytes32;
};

struct Matcher {
  const uint8_t* src;
  size_t n;
  LevelCfg cfg;
  int32_t* head;   // hash4 chain heads (thread-local scratch, -1 = empty)
  int32_t* prev;   // chain links, ring over the window
  int32_t* ht3;    // last occurrence per 3-byte hash (single entry)
  int hb;          // head/ht3 table bits (scaled to input size)
  uint32_t pmask;  // prev ring mask

  // Thread-local scratch: table construction cost dominated microsecond
  // inputs (a fresh 256 KiB head fill per call is ~20 us); tables are
  // sized to the input and cleared with memset instead.
  Matcher(const uint8_t* s, size_t end, const LevelCfg& c)
      : src(s), n(end), cfg(c) {
    hb = 16;
    while (hb > 12 && ((size_t)1 << (hb - 1)) >= end) hb--;
    size_t psz = (size_t)kWindow;
    while (psz > 1024 && (psz >> 1) >= end) psz >>= 1;
    pmask = (uint32_t)psz - 1;
    thread_local std::vector<int32_t> thead, tprev, tht3;
    if (thead.size() < ((size_t)1 << hb)) thead.resize((size_t)1 << hb);
    if (tprev.size() < psz) tprev.resize(psz);
    if (tht3.size() < ((size_t)1 << hb)) tht3.resize((size_t)1 << hb);
    head = thead.data();
    prev = tprev.data();
    ht3 = tht3.data();
    memset(head, 0xFF, sizeof(int32_t) << hb);
    memset(ht3, 0xFF, sizeof(int32_t) << hb);
  }

  inline uint32_t h3(uint32_t v) const {
    return ((v & 0xFFFFFF) * 0x9E3779B1u) >> (32 - hb);
  }
  inline uint32_t h4(uint32_t v) const {
    return (v * 0x9E3779B1u) >> (32 - hb);
  }

  // Insert position into the hash chains; returns the previous chain head.
  // Also records the position as the most recent occurrence of its 3-byte
  // prefix: a single-entry recency table finds RFC 1951's minimum match
  // length of 3 (the shortest distance for a 3-gram is also the cheapest
  // distance code), which a 4-byte chain hash can never see. Full 3-byte
  // chains would find the same matches but walk ~2.5x more candidates on
  // text; the split table keeps chain speed with the ratio win.
  int32_t cand3 = -1;  // previous 3-gram occurrence for the CURRENT insert
  inline int32_t insert(size_t pos) {
    uint32_t v = read32(src + pos);
    uint32_t h = h4(v);
    int32_t cand = head[h];
    head[h] = (int32_t)pos;
    prev[pos & pmask] = cand;
    uint32_t hh = h3(v);
    cand3 = ht3[hh];
    ht3[hh] = (int32_t)pos;
    return cand;
  }

  // Walk the chain from `cand`, best match for `pos`. prev_len biases the
  // search (only matches strictly longer matter in lazy mode).
  inline void find(size_t pos, int32_t cand, int prev_len, int& best_len,
                   uint32_t& best_dist) {
    best_dist = 0;
    int chain = cfg.chain;
    if (prev_len >= cfg.good) chain >>= 2;  // zlib good_match shortcut
    int max_len = (int)std::min<size_t>(kMaxMatch, n - pos);
    int floor_len = prev_len > 3 ? prev_len : 3;  // candidates must beat this
    best_len = floor_len;
    if (best_len >= max_len) {
      best_len = 0;
      return;
    }
    const uint8_t* scan = src + pos;
    uint32_t first4 = read32(scan);
    while (cand >= 0 && (size_t)cand + kWindow > pos && chain-- > 0) {
      // Cheap filter: a candidate can only improve on best_len if it also
      // matches the two bytes ending at scan[best_len] (zlib's scan_end
      // trick; two bytes reject far more of a long chain than one).
      if (read16(src + cand + best_len - 1) == read16(scan + best_len - 1) &&
          read32(src + cand) == first4) {
        int len = match_len(scan, src + cand, max_len);
        if (len > best_len) {
          best_len = len;
          best_dist = (uint32_t)(pos - cand);
          if (len >= cfg.nice || len >= max_len) break;
        }
      }
      int32_t nxt = prev[cand & pmask];
      cand = ((size_t)nxt < (size_t)cand) ? nxt : -1;
    }
    if (best_dist == 0 && prev_len < 3) {
      // Chains found nothing longer than 3: try the most recent 3-gram
      // (stashed by insert() before it overwrote the slot with pos).
      int32_t c3 = cand3;
      if (c3 >= 0 && (size_t)c3 < pos && (size_t)c3 + kWindow > pos &&
          ((read32(src + c3) ^ first4) & 0xFFFFFF) == 0) {
        int len = match_len(scan, src + c3, max_len);
        uint32_t dist = (uint32_t)(pos - c3);
        // A length-3 match farther than 4 KiB costs more bits than three
        // literals (zlib TOO_FAR rule).
        if (len >= 4 || dist <= 4096) {
          best_len = len;
          best_dist = dist;
          return;
        }
      }
    }
    if (best_dist == 0 || best_len <= prev_len) best_len = 0;
  }

  // Bulk insertion for positions inside an emitted match: chain links only.
  // Skipping the 3-gram recency store here saves a hash+store per position;
  // the single-entry table only feeds the "chains found nothing" fallback,
  // where a slightly stale 3-gram costs at most a marginally longer
  // distance code.
  inline void insert_bulk(size_t pos) {
    uint32_t v = read32(src + pos);
    uint32_t h = h4(v);
    prev[pos & pmask] = head[h];
    head[h] = (int32_t)pos;
  }

  // Record the strictly-lengthening candidate sequence for the optimal
  // parser: out[] gets packed (len-3)<<16 | (dist-1) entries with
  // increasing len and increasing dist, so for any target length the
  // FIRST candidate reaching it has the cheapest distance. The 3-gram
  // recency entry goes first (shortest possible distance).
  inline int gather(size_t pos, int32_t cand, uint32_t* out, int cap) {
    int cnt = 0;
    int max_len = (int)std::min<size_t>(kMaxMatch, n - pos);
    if (max_len < 3) return 0;
    const uint8_t* scan = src + pos;
    uint32_t first4 = read32(scan);
    int best = 2;
    int chain = cfg.chain;
    while (best < max_len && best < cfg.nice && cnt < cap - 1 && cand >= 0 &&
           (size_t)cand + kWindow > pos && chain-- > 0) {
      if (read16(src + cand + best - 1) == read16(scan + best - 1) &&
          read32(src + cand) == first4) {
        int len = match_len(scan, src + cand, max_len);
        if (len > best) {
          out[cnt++] = ((uint32_t)(len - 3) << 16) | ((uint32_t)(pos - cand) - 1);
          best = len;
        }
      }
      int32_t nxt = prev[cand & pmask];
      cand = ((size_t)nxt < (size_t)cand) ? nxt : -1;
    }
    // Merge the 3-gram recency candidate, preserving the invariant that
    // candidates strictly increase in BOTH len and dist (so the first
    // candidate reaching any target length has the cheapest distance).
    // The recency slot can be stale (bulk insertions skip it), so a chain
    // candidate may dominate it — e.g. on zero runs the chain holds
    // (len 258, dist 1) while the slot holds (len 258, dist 258).
    if (cand3 >= 0 && (size_t)cand3 < pos && (size_t)cand3 + kWindow > pos &&
        ((read32(src + cand3) ^ first4) & 0xFFFFFF) == 0) {
      int len3 = match_len(scan, src + cand3, max_len);
      uint32_t d3 = (uint32_t)(pos - cand3);
      if (len3 >= 4 || d3 <= 4096) {
        uint32_t c3 = ((uint32_t)(len3 - 3) << 16) | (d3 - 1);
        bool dominated = false;
        for (int i = 0; i < cnt; i++) {
          int li = (int)(out[i] >> 16) + 3;
          uint32_t di = (out[i] & 0xFFFF) + 1;
          if (li >= len3 && di <= d3) {
            dominated = true;
            break;
          }
        }
        if (!dominated) {
          // Drop chain candidates c3 dominates, insert c3 in len order.
          int w = 0;
          uint32_t merged[48];
          int i = 0;
          for (; i < cnt; i++) {
            int li = (int)(out[i] >> 16) + 3;
            uint32_t di = (out[i] & 0xFFFF) + 1;
            if (li > len3) break;          // goes after c3
            if (di > d3) continue;         // dominated by c3: drop
            merged[w++] = out[i];
          }
          merged[w++] = c3;
          for (; i < cnt; i++) merged[w++] = out[i];
          memcpy(out, merged, w * sizeof(uint32_t));
          cnt = w;
        }
      }
    }
    return cnt;
  }

  inline void insert_span(size_t from, size_t to) {  // [from, to)
    size_t lim = n >= (size_t)kMinMatch ? n - kMinMatch + 1 : 0;
    for (size_t i = from; i < std::min(to, lim); i++) insert_bulk(i);
  }
};

void emit_match(TokenStream& ts, int len, uint32_t dist) {
  ts.tokens.push_back(0x80000000u | ((uint32_t)(len - 3) << 16) | (dist - 1));
  ts.lit_freq[257 + kLenCode.idx[len - 3]]++;
  ts.dist_freq[kDistCode.code(dist)]++;
  ts.n_tokens_match++;
}

inline void flush_literal_run(TokenStream& ts, const uint8_t* src,
                              size_t from, size_t upto) {
  if (upto <= from) return;
  size_t run = upto - from;
  ts.n_literals += run;
  for (size_t i = from; i < upto; i++) ts.lit_freq[src[i]]++;
  while (run > 0) {
    uint32_t chunk = run > 0x7FFFFFFF ? 0x7FFFFFFF : (uint32_t)run;
    ts.tokens.push_back(chunk);
    run -= chunk;
  }
}

// Literal-run flush into 4 striped histograms (merged once at the end of
// tokenization). Popular bytes repeat back-to-back in real data; a single
// counter array serializes on store-to-load forwarding, 4 stripes don't.
inline void flush_literal_run4(TokenStream& ts, const uint8_t* src,
                               size_t from, size_t upto, uint32_t* h0,
                               uint32_t* h1, uint32_t* h2, uint32_t* h3) {
  if (upto <= from) return;
  size_t run = upto - from;
  ts.n_literals += run;
  size_t i = from;
  for (; i + 4 <= upto; i += 4) {
    h0[src[i]]++;
    h1[src[i + 1]]++;
    h2[src[i + 2]]++;
    h3[src[i + 3]]++;
  }
  for (; i < upto; i++) h0[src[i]]++;
  while (run > 0) {
    uint32_t chunk = run > 0x7FFFFFFF ? 0x7FFFFFFF : (uint32_t)run;
    ts.tokens.push_back(chunk);
    run -= chunk;
  }
}

// BestSpeed (level 1) matcher: direct-mapped 14-bit hash table, single probe,
// snappy-style skip-ahead through incompressible data (reference snappy.nim:
// encodeFragment :12, skip heuristic :90). No chains, no lazy evaluation.
// The probe loop is software-pipelined (snappy's next_hash trick): the load
// and hash of the NEXT probe position issue before the current candidate's
// content check resolves, so the table lookup latency and the (mispredict-
// prone) match branch overlap — ~1.6x on match-dense text.
void tokenize_fast(const uint8_t* src, size_t start, size_t end,
                   TokenStream& ts, size_t hist_from) {
  const int kFastBits = 14;
  // 16-bit RELATIVE positions keep the table at 32 KB (L1-resident; the
  // int32 version thrashed L1d). A stale entry reconstructs to a wrong
  // nearby position, which the read32 content check rejects — correctness
  // never depends on the table.
  thread_local std::vector<uint16_t> table;
  table.assign((size_t)1 << kFastBits, 0);
  auto fhash = [](uint32_t v) { return (v * 0x9E3779B1u) >> (32 - kFastBits); };
  // Seed history (sparsely — BestSpeed probes a direct-mapped table, so a
  // stride-4 far region + stride-2 near region keeps nearly all the hits
  // at half the seeding cost).
  size_t near = start > hist_from + 8192 ? start - 8192 : hist_from;
  for (size_t i = hist_from; i + kMinMatch <= near; i += 4)
    table[fhash(read32(src + i))] = (uint16_t)i;
  for (size_t i = near; i + kMinMatch <= start; i += 2)
    table[fhash(read32(src + i))] = (uint16_t)i;
  ts.tokens.reserve((end - start) / 8 + 16);
  ts.match_bytes32.assign(((end - start) >> 15) + 1, 0);
  uint32_t* mb32 = ts.match_bytes32.data();
  alignas(64) uint32_t hh0[256] = {0}, hh1[256] = {0}, hh2[256] = {0},
                       hh3[256] = {0};
  size_t pos = start, lit_start = start;
  uint32_t streak = 0;  // consecutive probes without a match
  uint32_t gear = 1;    // skip growth per miss (16 on incompressible input)
  if (pos + kMinMatch <= end) {
    uint32_t skip = 32;
    uint32_t next_v = read32(src + pos);
    uint32_t next_h = fhash(next_v);
    for (;;) {
      size_t cand;
      uint32_t v;
      for (;;) {  // probe until match or end of input
        v = next_v;
        uint32_t h = next_h;
        skip += gear;
        size_t next_pos = pos + (skip >> 5);
        cand = pos - (uint16_t)((pos - table[h]) & 0xFFFF);
        table[h] = (uint16_t)pos;
        bool hit = cand < pos && pos - cand <= kWindow &&
                   read32(src + cand) == v;
        if (next_pos + kMinMatch <= end) {
          // This load/hash overlaps the candidate check above.
          next_v = read32(src + next_pos);
          next_h = fhash(next_v);
        } else if (hit) {
          break;
        } else {
          pos = end;
          goto done;
        }
        if (hit) break;
        // Second gear: once 128 probes pass with NO match found in the
        // whole part (pure incompressible input, headed for the stored
        // fallback anyway) the stride grows 16x faster, slashing the probe
        // count on random data. Mixed content that has matched even once
        // never shifts gears, so ratios are untouched (reference
        // snappy.nim:90 grows linearly forever; a milder local re-arm was
        // measured to cost fireworks.jpg/paper-100k.pdf L1 their strict
        // size gates).
        if (++streak == 128 && ts.n_tokens_match == 0) gear = 16;
        pos = next_pos;
      }
      {
        int max_len = (int)std::min<size_t>(kMaxMatch, end - pos);
        int len = match_len(src + pos, src + cand, max_len);
        // Extend the match backward over trailing literals (the probe grid
        // lands mid-repeat on structured data; zlib's per-position chains
        // see the true start). A few byte compares per match buys ~0.5-1%
        // ratio on mixed content. Extension continues past the 258 cap —
        // the emitted length saturates and the rep-distance loop below
        // covers the remainder with further matches.
        while (pos > lit_start && cand > 0 && src[pos - 1] == src[cand - 1]) {
          pos--;
          cand--;
          if (len < kMaxMatch) len++;
        }
        flush_literal_run4(ts, src, lit_start, pos, hh0, hh1, hh2, hh3);
        uint32_t d = (uint32_t)(pos - cand);
        emit_match(ts, len, d);
        mb32[(pos - start) >> 15] += (uint32_t)len;
        size_t e = pos + (size_t)len;
        // Rep-distance continuation: a maximal (258-byte) match almost
        // always continues at the same distance; chaining directly skips
        // the probe table, whose inserts are sparse after an
        // incompressible gear phase (e.g. a large random block repeated —
        // copy 1 ran at gear 16, so copy 2's probes would mostly miss).
        while (len == kMaxMatch && e + 4 <= end &&
               read32(src + e) == read32(src + e - d)) {
          int rep_max = (int)std::min<size_t>(kMaxMatch, end - e);
          len = match_len(src + e, src + e - d, rep_max);
          emit_match(ts, len, d);
          mb32[(e - start) >> 15] += (uint32_t)len;
          e += (size_t)len;
        }
        // Seed the table near the match end so back-to-back matches chain.
        if (e >= 2 && e - 2 + 4 <= end)
          table[fhash(read32(src + e - 2))] = (uint16_t)(e - 2);
        if (e - 1 + 4 <= end)
          table[fhash(read32(src + e - 1))] = (uint16_t)(e - 1);
        pos = e;
        lit_start = pos;
        skip = 32;
        streak = 0;
        gear = 1;
        if (pos + kMinMatch > end) break;
        next_v = read32(src + pos);
        next_h = fhash(next_v);
      }
    }
  }
done:
  flush_literal_run4(ts, src, lit_start, end, hh0, hh1, hh2, hh3);
  for (int i = 0; i < 256; i++)
    ts.lit_freq[i] += hh0[i] + hh1[i] + hh2[i] + hh3[i];
  ts.lit_freq[256]++;
}


// ---------------------------------------------------------------------------
// Near-optimal parse (levels 8-9): gather every strictly-lengthening match
// candidate per position, then iterate a cost-model backward DP — parse
// under estimated symbol costs, rebuild Huffman lengths from the parse,
// re-parse under the refined costs. Two iterations land within a fraction
// of a percent of the true optimum (libdeflate's approach); the serial
// heuristics zlib/zippy use (lazy one-step deferral) leave 0.5-2% behind.
// The reference has no counterpart (greedy only, lz77.nim:88-112).
// ---------------------------------------------------------------------------

void tokenize_optimal(const uint8_t* src, size_t start, size_t end, int level,
                      TokenStream& ts, size_t hist_from) {
  // Effort ladder: L7 is the budget tier (shallow gather, few candidates —
  // the DP recovers most of the parse win at a fraction of the chain-walk
  // cost); L8/9 search deep.
  LevelCfg cfg = kLevels[level];
  if (level <= 7) cfg.chain = 64;
  const int iters = level >= 9 ? 3 : 2;
  const int kCap = level <= 7 ? 16 : 40;
  Matcher m(src, end, cfg);
  m.insert_span(hist_from, start);

  const size_t W = end - start;
  thread_local std::vector<uint32_t> cands;
  thread_local std::vector<uint32_t> coff;  // candidate range per position
  cands.clear();
  coff.assign(W + 1, 0);
  uint32_t buf[48];
  for (size_t pos = start; pos + kMinMatch <= end; pos++) {
    int32_t cand = m.insert(pos);
    int cnt = m.gather(pos, cand, buf, kCap);
    coff[pos - start] = (uint32_t)cands.size();
    for (int i = 0; i < cnt; i++) cands.push_back(buf[i]);
    coff[pos - start + 1] = (uint32_t)cands.size();
    // Run shortcut: inside a maximal match, candidates repeat; skip ahead
    // inserting only (the DP takes the long match anyway).
    if (cnt && ((buf[cnt - 1] >> 16) + 3) >= 250) {
      size_t len = (buf[cnt - 1] >> 16) + 3;
      size_t e = std::min(pos + len, end);
      m.insert_span(pos + 1, e);
      for (size_t q = pos + 1; q < e && q + kMinMatch <= end; q++)
        coff[q - start + 1] = (uint32_t)cands.size();
      pos = e - 1;  // ++ advances past
      continue;
    }
  }
  // Monotone fill: tail positions (and run-shortcut gaps) never gathered.
  for (size_t q = 1; q <= W; q++)
    if (coff[q] < coff[q - 1]) coff[q] = coff[q - 1];

  // Cost tables, seeded from the fixed Huffman code (iteration 0).
  // len_cost is uint32 (8-padded) so the DP inner loop can vector-add it
  // against the cost[] suffix array with unaligned 256-bit loads.
  uint16_t lit_cost[256], dist_cost[30];
  alignas(32) uint32_t len_cost[264];
  for (int i = 0; i < 144; i++) lit_cost[i] = 8;
  for (int i = 144; i < 256; i++) lit_cost[i] = 9;
  for (int l = 0; l < 256; l++) {
    int li = kLenCode.idx[l];
    len_cost[l] = (uint32_t)((257 + li < 280 ? 7 : 8) + kLengthExtra[li]);
  }
  for (int l = 256; l < 264; l++) len_cost[l] = 0x3FFFFFFF;
  for (int d = 0; d < 30; d++) dist_cost[d] = (uint16_t)(5 + kDistExtra[d]);

  thread_local std::vector<uint32_t> cost;
  thread_local std::vector<uint32_t> choice;
  // 8 sentinel entries past cost[W] let the vector loop overread harmlessly
  // (the sentinels are large enough to never win a min, small enough that
  // adding a code length cannot overflow).
  cost.assign(W + 9, 0x3FFFFFFF);
  cost[W] = 0;
  choice.assign(W, 0);

  for (int it = 0; it < iters; it++) {
    // Backward DP.
    for (size_t r = W; r-- > 0;) {
      uint32_t c = lit_cost[src[start + r]] + cost[r + 1];
      uint32_t ch = 0;
      uint32_t lo = coff[r], hi = coff[r + 1];
      int prev_hi = 2;
      for (uint32_t k = lo; k < hi; k++) {
        uint32_t packed = cands[k];
        int len_k = (int)(packed >> 16) + 3;
        uint32_t dist1 = packed & 0xFFFF;
        uint16_t dc = dist_cost[kDistCode.code(dist1 + 1)];
        if (len_k >= 250) {
          // Forced long match: evaluating every shorter length is wasted
          // work on runs.
          size_t tgt = r + (size_t)len_k;
          if (tgt <= W) {
            uint32_t t = cost[tgt] + len_cost[len_k - 3] + dc;
            if (t < c) {
              c = t;
              ch = 0x80000000u | ((uint32_t)(len_k - 3) << 16) | dist1;
            }
          }
          prev_hi = len_k;
          continue;
        }
        int cap_len = (int)std::min<size_t>(len_k, W - r);
        int lp = prev_hi + 1;
#if defined(__AVX2__)
        if (cap_len - lp >= 7) {
          // min(cost[r+lp] + len_cost[lp-3]) over the candidate's length
          // range, 8 lanes at a time, tracking the achieving lp per lane.
          __m256i vbest = _mm256_set1_epi32(0x7FFFFFFF);
          __m256i vblp = _mm256_setzero_si256();
          __m256i vlp = _mm256_add_epi32(
              _mm256_set1_epi32(lp),
              _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7));
          const __m256i v8 = _mm256_set1_epi32(8);
          for (; lp + 7 <= cap_len; lp += 8) {
            __m256i vc = _mm256_loadu_si256((const __m256i*)&cost[r + lp]);
            __m256i vl =
                _mm256_loadu_si256((const __m256i*)&len_cost[lp - 3]);
            __m256i vt = _mm256_add_epi32(vc, vl);
            vbest = _mm256_min_epu32(vt, vbest);
            __m256i upd = _mm256_cmpeq_epi32(vbest, vt);
            vblp = _mm256_blendv_epi8(vblp, vlp, upd);
            vlp = _mm256_add_epi32(vlp, v8);
          }
          alignas(32) uint32_t bv[8], bl[8];
          _mm256_store_si256((__m256i*)bv, vbest);
          _mm256_store_si256((__m256i*)bl, vblp);
          for (int i = 0; i < 8; i++) {
            uint32_t t = bv[i] + dc;
            if (t < c) {
              c = t;
              ch = 0x80000000u | ((bl[i] - 3) << 16) | dist1;
            }
          }
        }
#endif
        for (; lp <= cap_len; lp++) {
          uint32_t t = cost[r + lp] + len_cost[lp - 3] + dc;
          if (t < c) {
            c = t;
            // Bit 31 flags a match: a len-3/dist-1 choice would otherwise
            // pack to 0 and collide with the literal sentinel (the DP would
            // account a match but the trace would emit literals).
            ch = 0x80000000u | ((uint32_t)(lp - 3) << 16) | dist1;
          }
        }
        prev_hi = len_k;
      }
      cost[r] = c;
      choice[r] = ch;
    }
    if (it + 1 == iters) break;
    // Refine costs: trace the parse, rebuild optimal lengths, reprice.
    uint32_t lf[286] = {0}, df[30] = {0};
    size_t r = 0;
    while (r < W) {
      uint32_t ch = choice[r];
      if (!(ch & 0x80000000u)) {
        lf[src[start + r]]++;
        r++;
      } else {
        int len = (int)((ch >> 16) & 0x7FFF) + 3;
        lf[257 + kLenCode.idx[len - 3]]++;
        df[kDistCode.code((ch & 0xFFFF) + 1)]++;
        r += len;
      }
    }
    lf[256]++;
    uint8_t ll[286], dl[30];
    build_code_lengths(lf, 286, 15, ll);
    build_code_lengths(df, 30, 15, dl);
    for (int i = 0; i < 256; i++)
      lit_cost[i] = ll[i] ? ll[i] : 13;  // unused: discourage, keep legal
    for (int l = 0; l < 256; l++) {
      int li = kLenCode.idx[l];
      int sym = 257 + li;
      len_cost[l] = (uint16_t)((ll[sym] ? ll[sym] : 13) + kLengthExtra[li]);
    }
    for (int d = 0; d < 30; d++)
      dist_cost[d] = (uint16_t)((dl[d] ? dl[d] : 13) + kDistExtra[d]);
  }

  // Emit the final parse as tokens.
  size_t r = 0, lit_from = 0;
  while (r < W) {
    uint32_t ch = choice[r];
    if (!(ch & 0x80000000u)) {
      r++;
      continue;
    }
    if (r > lit_from)
      flush_literal_run(ts, src, start + lit_from, start + r);
    int len = (int)((ch >> 16) & 0x7FFF) + 3;
    emit_match(ts, len, (ch & 0xFFFF) + 1);
    r += len;
    lit_from = r;
  }
  if (W > lit_from) flush_literal_run(ts, src, start + lit_from, start + W);
  ts.lit_freq[256]++;
}

void tokenize(const uint8_t* src, size_t start, size_t end, int level,
              TokenStream& ts, size_t hist_from) {
  if (level >= 7) {
    tokenize_optimal(src, start, end, level, ts, hist_from);
    return;
  }
  if (level == 1 && end - start > 4096) {
    // BestSpeed single-probe matcher; tiny inputs fall through to the
    // greedy hash chain below instead (zlib's deflate_fast quality at
    // microsecond cost — the probe table setup dominates at this size).
    tokenize_fast(src, start, end, ts, hist_from);
    return;
  }
  // Tiny-input quality floor: at <= 1 KiB the matcher cost is sub-us at
  // any depth, so levels 1-4 borrow level 5's lazy config (a 20-byte
  // header blob should never code worse at BestSpeed than at L5).
  const bool tiny = end - start <= 1024;
  const LevelCfg cfg = kLevels[tiny && level < 5 ? 5 : level];
  const size_t n = end;
  Matcher m(src, end, cfg);
  // Seed the window with history before the encode start (cross-boundary
  // matches; the reference resets its window per 4 MiB block instead,
  // lz77.nim:63-64 — continuous history is a strict ratio improvement).
  m.insert_span(hist_from, start);
  size_t pos = start;
  size_t lit_start = start;
  int miss_streak = 0;
  const bool skip_ahead = level == 1 && !tiny;
  const bool lazy_eval = level >= 4 || tiny;  // zlib deflate_slow territory

  auto flush_literals = [&](size_t upto) {
    if (upto > lit_start) {
      size_t run = upto - lit_start;
      ts.n_literals += run;
      for (size_t i = lit_start; i < upto; i++) ts.lit_freq[src[i]]++;
      while (run > 0) {
        uint32_t chunk = run > 0x7FFFFFFF ? 0x7FFFFFFF : (uint32_t)run;
        ts.tokens.push_back(chunk);
        run -= chunk;
      }
    }
  };

  if (!lazy_eval) {
    // Greedy path (levels 1-3; reference lz77.nim is greedy at all levels).
    while (pos + kMinMatch <= n) {
      int32_t cand = m.insert(pos);
      int best_len;
      uint32_t best_dist;
      m.find(pos, cand, 0, best_len, best_dist);
      if (best_len >= 3) {
        flush_literals(pos);
        emit_match(ts, best_len, best_dist);
        size_t ins_end = pos + (size_t)best_len;
        size_t ins = pos + 1;
        if (level <= 3 && best_len > cfg.lazy * 8) ins = ins_end;  // speed cap
        m.insert_span(ins, ins_end);
        pos += best_len;
        lit_start = pos;
        miss_streak = 0;
      } else {
        miss_streak++;
        pos += skip_ahead ? 1 + (miss_streak >> 5) : 1;
      }
    }
  } else {
    // Lazy path (levels 4-9): defer each match one position; if the next
    // position matches longer, the previous byte becomes a literal.
    int prev_len = 0;
    uint32_t prev_dist = 0;
    bool have_prev = false;
    while (pos + kMinMatch <= n) {
      int32_t cand = m.insert(pos);
      int len;
      uint32_t dist;
      if (have_prev && prev_len >= cfg.lazy) {
        len = 0;  // prev match is long enough; don't bother searching
        dist = 0;
      } else {
        m.find(pos, cand, have_prev ? prev_len : 0, len, dist);
      }
      if (have_prev && prev_len >= len) {
        // Previous match wins: it started at pos-1.
        flush_literals(pos - 1);
        emit_match(ts, prev_len, prev_dist);
        size_t match_end = pos - 1 + (size_t)prev_len;
        m.insert_span(pos + 1, match_end);
        pos = match_end;
        lit_start = pos;
        have_prev = false;
      } else if (len >= 3) {
        // Current match becomes the new pending match; pos-1 (if pending)
        // degrades to a literal inside the running literal span.
        prev_len = len;
        prev_dist = dist;
        have_prev = true;
        pos++;
      } else {
        have_prev = false;
        pos++;
      }
    }
    if (have_prev) {
      // Pending match at the very end.
      flush_literals(pos - 1);
      emit_match(ts, prev_len, prev_dist);
      size_t match_end = pos - 1 + (size_t)prev_len;
      lit_start = std::min(match_end, n);
      pos = lit_start;
    }
  }
  flush_literals(n);
  ts.lit_freq[256]++;  // end-of-block
}

// ---------------------------------------------------------------------------
// Block emission: choose min(stored, fixed, dynamic) like zlib; the reference
// uses a >=98%-literal stored fallback + small-block fixed rule instead
// (deflate.nim:275-280) — exact cost comparison is strictly better.
// ---------------------------------------------------------------------------

struct CodeSet {
  uint8_t litlen_lens[286] = {0};
  uint8_t dist_lens[30] = {0};
  uint16_t litlen_codes[286];
  uint16_t dist_codes[30];
};

void fixed_codeset(CodeSet& cs) {
  for (int i = 0; i < 144; i++) cs.litlen_lens[i] = 8;
  for (int i = 144; i < 256; i++) cs.litlen_lens[i] = 9;
  for (int i = 256; i < 280; i++) cs.litlen_lens[i] = 7;
  for (int i = 280; i < 286; i++) cs.litlen_lens[i] = 8;
  for (int i = 0; i < 30; i++) cs.dist_lens[i] = 5;
  // canonical over the full 288 fixed alphabet, then truncate
  uint8_t full[288];
  for (int i = 0; i < 144; i++) full[i] = 8;
  for (int i = 144; i < 256; i++) full[i] = 9;
  for (int i = 256; i < 280; i++) full[i] = 7;
  for (int i = 280; i < 288; i++) full[i] = 8;
  uint16_t codes[288];
  canonical_codes(full, 288, codes);
  memcpy(cs.litlen_codes, codes, sizeof(uint16_t) * 286);
  canonical_codes(cs.dist_lens, 30, cs.dist_codes);
}

// Code-length RLE for the dynamic header (RFC 1951 §3.2.7). Emits symbol
// stream into `out` as (sym, extra_val, extra_bits) triples packed in uint32.
size_t rle_code_lengths(const uint8_t* lens, int n, uint32_t* out,
                        uint32_t* cl_freq) {
  size_t m = 0;
  int i = 0;
  while (i < n) {
    int v = lens[i];
    int run = 1;
    while (i + run < n && lens[i + run] == v) run++;
    if (v == 0) {
      int r = run;
      while (r >= 3) {
        int take = std::min(r, 138);
        if (take > 10) {
          out[m++] = 18u | ((uint32_t)(take - 11) << 8) | (7u << 24);
          cl_freq[18]++;
        } else {
          out[m++] = 17u | ((uint32_t)(take - 3) << 8) | (3u << 24);
          cl_freq[17]++;
        }
        r -= take;
      }
      while (r-- > 0) {
        out[m++] = 0;
        cl_freq[0]++;
      }
    } else {
      out[m++] = (uint32_t)v;
      cl_freq[v]++;
      int r = run - 1;
      while (r >= 3) {
        int take = std::min(r, 6);
        out[m++] = 16u | ((uint32_t)(take - 3) << 8) | (2u << 24);
        cl_freq[16]++;
        r -= take;
      }
      while (r-- > 0) {
        out[m++] = (uint32_t)v;
        cl_freq[v]++;
      }
    }
    i += run;
  }
  return m;
}

uint64_t huffman_cost_bits(const uint32_t* lit_freq, const uint32_t* dist_freq,
                           const uint8_t* ll_lens, const uint8_t* d_lens) {
  uint64_t bits = 0;
  for (int s = 0; s < 286; s++)
    if (lit_freq[s]) {
      if (!ll_lens[s]) return UINT64_MAX;  // symbol not codable
      bits += (uint64_t)lit_freq[s] * ll_lens[s];
      if (s >= 265 && s < 285) bits += (uint64_t)lit_freq[s] * kLengthExtra[s - 257];
    }
  for (int s = 0; s < 30; s++)
    if (dist_freq[s]) {
      if (!d_lens[s]) return UINT64_MAX;
      bits += (uint64_t)dist_freq[s] * (d_lens[s] + kDistExtra[s]);
    }
  return bits;
}

uint64_t huffman_cost_bits(const TokenStream& ts, const uint8_t* ll_lens,
                           const uint8_t* d_lens) {
  return huffman_cost_bits(ts.lit_freq, ts.dist_freq, ll_lens, d_lens);
}

// Precomputed per-CodeSet emit tables: fused (bits|nbits<<24) entries for
// literals, match lengths (huffman code + extra bits in one shot), and
// distance codes. Built once per block (~1k entries), amortized over the
// token stream.
struct EmitLut {
  uint32_t lit[256];        // code | nbits<<24
  uint32_t len[256];        // fused length sym + extra | nbits<<24
  uint32_t dist_code[30];   // code | nbits<<24 (extra appended at emit)
  uint32_t eob;
  int eob_n;
  int max_lit_bits;
  void build(const CodeSet& cs) {
    max_lit_bits = 0;
    for (int i = 0; i < 256; i++) {
      lit[i] = cs.litlen_codes[i] | ((uint32_t)cs.litlen_lens[i] << 24);
      if (cs.litlen_lens[i] > max_lit_bits) max_lit_bits = cs.litlen_lens[i];
    }
    for (int l = 0; l < 256; l++) {
      int li = kLenCode.idx[l];
      int ls = 257 + li;
      uint32_t v = cs.litlen_codes[ls];
      int n = cs.litlen_lens[ls];
      v |= (uint32_t)(l + 3 - kBaseLengths[li]) << n;
      n += kLengthExtra[li];
      len[l] = v | ((uint32_t)n << 24);
    }
    for (int d = 0; d < 30; d++)
      dist_code[d] = cs.dist_codes[d] | ((uint32_t)cs.dist_lens[d] << 24);
    eob = cs.litlen_codes[256];
    eob_n = cs.litlen_lens[256];
  }
};

// Branchless 64-bit serializer (libdeflate-style): accumulate into a 64-bit
// buffer and unconditionally store 8 bytes per flush, advancing by whole
// bytes — no per-add branch. PAIRS = literal pairs accumulated per flush
// (bounded by worst-case literal code length so the buffer can't overflow:
// 7 carried bits + PAIRS*2*max_lit_bits <= 64).
template <int PAIRS>
static void emit_tokens_fb(BitWriter& bw, const uint8_t* src, size_t start,
                           const uint32_t* toks, size_t ntok,
                           const EmitLut& lut, bool emit_eob) {
  uint64_t buf = bw.buf;
  unsigned cnt = (unsigned)bw.cnt;  // < 32 on entry (BitWriter invariant)
  uint8_t* p = bw.dst + bw.pos;
  uint8_t* hard_end = bw.dst + bw.cap;
  size_t pos = start;
  bool full = false;
  auto flush = [&] {
    memcpy(p, &buf, 8);
    unsigned nb = cnt >> 3;
    p += nb;
    buf >>= nb * 8;
    cnt &= 7;
  };
  auto addlit = [&](uint8_t b) {
    uint32_t e = lut.lit[b];
    buf |= (uint64_t)(e & 0xFFFF) << cnt;
    cnt += e >> 24;
  };
  // Entry flush: bw may carry up to 31 bits (e.g. right after the dynamic
  // header); every accumulation bound below assumes <= 7 carried bits.
  if (p + 8 > hard_end) {
    bw.full = true;
    return;
  }
  flush();
  for (size_t ti = 0; ti < ntok; ti++) {
    uint32_t t = toks[ti];
    if (t & 0x80000000u) {
      if (p + 16 > hard_end) {
        full = true;
        break;
      }
      uint32_t l = (t >> 16) & 0xFF;
      uint32_t dist = (t & 0xFFFF) + 1;
      uint32_t lv = lut.len[l];
      buf |= (uint64_t)(lv & 0xFFFFFF) << cnt;  // <= 20 bits
      cnt += lv >> 24;
      flush();
      int di = kDistCode.code(dist);
      uint32_t dv = lut.dist_code[di];
      uint32_t dn = dv >> 24;
      buf |= (uint64_t)((dv & 0xFFFFFF) | ((dist - kBaseDists[di]) << dn))
             << cnt;  // <= 28 bits
      cnt += dn + kDistExtra[di];
      flush();
      pos += l + 3;
    } else {
      const uint8_t* lp = src + pos;
      uint32_t k = 0;
      for (; k + 2 * PAIRS <= t; k += 2 * PAIRS) {
        if (p + 8 > hard_end) {
          full = true;
          goto out;
        }
        for (int j = 0; j < 2 * PAIRS; j++) addlit(lp[k + j]);
        flush();
      }
      for (; k < t; k++) {
        if (p + 8 > hard_end) {
          full = true;
          goto out;
        }
        addlit(lp[k]);
        flush();
      }
      pos += t;
    }
  }
out:
  if (emit_eob && !full) {
    if (p + 8 > hard_end) {
      full = true;
    } else {
      buf |= (uint64_t)lut.eob << cnt;
      cnt += lut.eob_n;
      flush();
    }
  }
  bw.buf = buf;
  bw.cnt = (int)cnt;
  bw.pos = p - bw.dst;
  if (full) bw.full = true;
}

// Fallback serializer with a branch-on-fill writer. Wins only on streams of
// LONG literal runs under >12-bit codes (e.g. near-incompressible data under
// a skewed dynamic table), where its add-branch is perfectly predicted and
// the branchless path's per-pair 8-byte store is pure overhead.
static void emit_tokens_branchy(BitWriter& bw, const uint8_t* src,
                                size_t start, const uint32_t* toks,
                                size_t ntok, const CodeSet& cs,
                                bool emit_eob) {
  size_t pos = start;
  for (size_t ti = 0; ti < ntok; ti++) {
    uint32_t t = toks[ti];
    if (t & 0x80000000u) {
      uint32_t len = ((t >> 16) & 0xFF) + 3;
      uint32_t dist = (t & 0xFFFF) + 1;
      int li = kLenCode.idx[len - 3];
      int ls = 257 + li;
      bw.add(cs.litlen_codes[ls], cs.litlen_lens[ls]);
      if (kLengthExtra[li]) bw.add(len - kBaseLengths[li], kLengthExtra[li]);
      int di = kDistCode.code(dist);
      bw.add(cs.dist_codes[di], cs.dist_lens[di]);
      if (kDistExtra[di]) bw.add(dist - kBaseDists[di], kDistExtra[di]);
      pos += len;
    } else {
      // Two literals per add(): codes are <= 15 bits so a pair fits in 30.
      const uint8_t* lp = src + pos;
      uint32_t k = 0;
      for (; k + 2 <= t; k += 2) {
        uint8_t b0 = lp[k], b1 = lp[k + 1];
        int l0 = cs.litlen_lens[b0];
        bw.add(cs.litlen_codes[b0] | ((uint32_t)cs.litlen_codes[b1] << l0),
               l0 + cs.litlen_lens[b1]);
      }
      if (k < t) bw.add(cs.litlen_codes[lp[k]], cs.litlen_lens[lp[k]]);
      pos += t;
    }
  }
  if (emit_eob)
    bw.add(cs.litlen_codes[256], cs.litlen_lens[256]);  // end of block
}

void emit_tokens_span(BitWriter& bw, const uint8_t* src, size_t start,
                      const uint32_t* toks, size_t ntok, size_t n_literals,
                      size_t n_match_tokens, const CodeSet& cs,
                      bool emit_eob = true) {
  EmitLut lut;
  lut.build(cs);
  if (lut.max_lit_bits <= 9) {
    emit_tokens_fb<3>(bw, src, start, toks, ntok, lut, emit_eob);
  } else if (lut.max_lit_bits <= 12) {
    emit_tokens_fb<2>(bw, src, start, toks, ntok, lut, emit_eob);
  } else {
    // >12-bit literal codes force single-pair flush groups; those only lose
    // to the branchy writer when runs are long (predictable add-branch).
    size_t lit_tokens = ntok - n_match_tokens;
    if (lit_tokens > 0 && n_literals > 8 * lit_tokens)
      emit_tokens_branchy(bw, src, start, toks, ntok, cs, emit_eob);
    else
      emit_tokens_fb<1>(bw, src, start, toks, ntok, lut, emit_eob);
  }
}

void emit_tokens(BitWriter& bw, const uint8_t* src, size_t start,
                 const TokenStream& ts, const CodeSet& cs,
                 bool emit_eob = true) {
  emit_tokens_span(bw, src, start, ts.tokens.data(), ts.tokens.size(),
                   ts.n_literals, ts.n_tokens_match, cs, emit_eob);
}

void emit_stored(BitWriter& bw, const uint8_t* src, size_t start, size_t len,
                 bool final_block) {
  size_t off = 0;
  do {
    size_t chunk = std::min(len - off, kMaxStored);
    bool last_chunk = (off + chunk == len);
    bw.add((final_block && last_chunk) ? 1 : 0, 1);
    bw.add(0, 2);
    bw.align_byte();
    bw.add((uint32_t)chunk & 0xFFFF, 16);
    bw.add((~(uint32_t)chunk) & 0xFFFF, 16);
    // write payload bytes directly (writer is byte-aligned with <8 buffered
    // bits == 0 after align; flush them)
    while (bw.cnt >= 8) {
      if (bw.pos < bw.cap)
        bw.dst[bw.pos] = (uint8_t)bw.buf;
      else
        bw.full = true;
      bw.pos++;
      bw.buf >>= 8;
      bw.cnt -= 8;
    }
    bw.write_bytes(src + start + off, chunk);
    off += chunk;
  } while (off < len);
}

// Encode src as deflate blocks into dst. `mark_final` controls BFINAL on
// the last block; when `pad_to_byte` is false the result is the exact BIT
// length (callers splice sub-streams at arbitrary bit offsets), otherwise
// the padded byte length.

// Dynamic-block planning shared by the per-block and MT shared-code paths.
struct DynPlan {
  CodeSet dyn;
  uint32_t rle[286 + 30];
  size_t rle_n;
  uint8_t cl_lens[19];
  uint16_t cl_codes[19];
  int hlit, hdist, hclen;
  uint64_t header_bits;
};

void plan_dynamic(const uint32_t* lit_freq, const uint32_t* dist_freq,
                  DynPlan& p, bool approx = false) {
  // approx: Kraft-clamped lengths instead of package-merge — for the
  // segmentation planner's cost comparisons only (never emitted).
  if (approx) {
    build_code_lengths_approx(lit_freq, 286, 15, p.dyn.litlen_lens);
    build_code_lengths_approx(dist_freq, 30, 15, p.dyn.dist_lens);
  } else {
    build_code_lengths(lit_freq, 286, 15, p.dyn.litlen_lens);
    build_code_lengths(dist_freq, 30, 15, p.dyn.dist_lens);
  }
  if (!p.dyn.litlen_lens[256]) p.dyn.litlen_lens[256] = 15;
  {
    int nz = 0;
    for (int i = 0; i < 286; i++) nz += p.dyn.litlen_lens[i] != 0;
    if (nz < 2) {
      for (int i = 0; i < 286 && nz < 2; i++)
        if (!p.dyn.litlen_lens[i]) {
          p.dyn.litlen_lens[i] = 1;
          nz++;
        }
      if (p.dyn.litlen_lens[256] > 1) p.dyn.litlen_lens[256] = 1;
    }
  }
  canonical_codes(p.dyn.litlen_lens, 286, p.dyn.litlen_codes);
  canonical_codes(p.dyn.dist_lens, 30, p.dyn.dist_codes);

  p.hlit = 286;
  while (p.hlit > 257 && p.dyn.litlen_lens[p.hlit - 1] == 0) p.hlit--;
  p.hdist = 30;
  while (p.hdist > 1 && p.dyn.dist_lens[p.hdist - 1] == 0) p.hdist--;
  uint8_t all_lens[286 + 30];
  memcpy(all_lens, p.dyn.litlen_lens, p.hlit);
  memcpy(all_lens + p.hlit, p.dyn.dist_lens, p.hdist);
  uint32_t cl_freq[19] = {0};
  p.rle_n = rle_code_lengths(all_lens, p.hlit + p.hdist, p.rle, cl_freq);
  build_code_lengths(cl_freq, 19, 7, p.cl_lens);
  canonical_codes(p.cl_lens, 19, p.cl_codes);
  p.hclen = 19;
  while (p.hclen > 4 && p.cl_lens[kClclOrder[p.hclen - 1]] == 0) p.hclen--;

  p.header_bits = 5 + 5 + 4 + 3ull * p.hclen;
  for (size_t i = 0; i < p.rle_n; i++) {
    uint32_t sym = p.rle[i] & 0xFF;
    p.header_bits += p.cl_lens[sym] + (p.rle[i] >> 24);
  }
}

void emit_dynamic_header(BitWriter& bw, const DynPlan& p) {
  bw.add((uint32_t)(p.hlit - 257), 5);
  bw.add((uint32_t)(p.hdist - 1), 5);
  bw.add((uint32_t)(p.hclen - 4), 4);
  for (int i = 0; i < p.hclen; i++) bw.add(p.cl_lens[kClclOrder[i]], 3);
  for (size_t i = 0; i < p.rle_n; i++) {
    uint32_t sym = p.rle[i] & 0xFF;
    bw.add(p.cl_codes[sym], p.cl_lens[sym]);
    uint32_t extra = p.rle[i] >> 24;
    if (extra) bw.add((p.rle[i] >> 8) & 0xFFFF, (int)extra);
  }
}

// ---------------------------------------------------------------------------
// Content-adaptive block segmentation.
//
// A single dynamic-Huffman block over heterogeneous content (text followed
// by an incompressible tail, or drifting symbol distributions) pays real
// bits: one global code table serves every region. zlib wins those inputs
// purely through its small (~16 KiB-symbol) blocks with per-block tables.
// We do better: partition the token stream into fine chunks, merge adjacent
// chunks bottom-up under an entropy cost estimate, then refine the surviving
// boundaries with EXACT package-merge costs, emitting each final segment as
// its own stored/fixed/dynamic block (the reference's stored fallback,
// deflate.nim:275-277, generalized to interior sub-block segments).
// ---------------------------------------------------------------------------

const int kSegLitDist = 286 + 30;  // per-chunk histogram stride

struct ChunkMeta {
  size_t tok_begin, tok_end;   // token range in the rewritten stream
  size_t byte_begin, byte_end; // input byte range
  uint64_t extra_bits;         // match length/dist extra bits in the range
  size_t n_literals;
  size_t n_match;
};

// Fast log2 for entropy estimation: exact exponent from the float bit
// pattern plus a 2nd-order polynomial on the mantissa (|err| < 0.01 bits).
// Only used for merge ESTIMATES; final block choices use exact bit counts.
static inline float flog2(float x) {
  union {
    float f;
    uint32_t i;
  } u{x};
  int e = (int)(u.i >> 23) - 127;
  u.i = (u.i & 0x7FFFFF) | 0x3F800000;  // mantissa in [1,2)
  float m = u.f;
  // log2(m) ~= -1.674903 + 2.024658*m - 0.3448453*m^2  on [1,2)
  return (float)e + (-1.674903f + (2.024658f - 0.3448453f * m) * m);
}

// Estimated cost in bits of one segment: min(entropy-coded, stored).
// Header estimate tracks the dynamic header's real size shape (fixed cost +
// per-distinct-symbol RLE cost); biased slightly low so borderline splits
// survive to the exact refinement pass (which can only merge).
static double seg_cost_est(const uint32_t* lf, const uint32_t* df,
                           const ChunkMeta& m, bool* stored_won = nullptr) {
  uint64_t F = 1;  // + EOB
  for (int i = 0; i < 286; i++) F += lf[i];
  float logF = flog2((float)F);
  double h = logF;  // EOB cost approximation
  int distinct = 1;
  for (int i = 0; i < 286; i++)
    if (lf[i]) {
      h += (double)lf[i] * (logF - flog2((float)lf[i]));
      distinct++;
    }
  uint64_t D = 0;
  for (int i = 0; i < 30; i++) D += df[i];
  if (D) {
    float logD = flog2((float)D);
    for (int i = 0; i < 30; i++)
      if (df[i]) {
        h += (double)df[i] * (logD - flog2((float)df[i]));
        distinct++;
      }
  }
  double coded = 3 + 64 + 5.0 * distinct + h + (double)m.extra_bits;
  size_t blen = m.byte_end - m.byte_begin;
  double stored =
      8.0 * (blen + 5 * ((blen + kMaxStored - 1) / kMaxStored)) + 6;
  if (stored_won) *stored_won = stored < coded;
  return std::min(coded, stored);
}

const CodeSet& fixed_cs() {
  static const CodeSet cs = [] {
    CodeSet c;
    fixed_codeset(c);
    return c;
  }();
  return cs;
}

void zt_parallel_for(size_t n, const std::function<void(size_t)>& fn);

// Exact cost (bits) of emitting one segment as its own block, with the mode
// choice. freq arrays are WITHOUT the EOB count (added here). Fills `plan`
// when dynamic wins.
static uint64_t seg_exact_cost(const uint32_t* lf_noeob, const uint32_t* df,
                               const ChunkMeta& m, DynPlan& plan, int& mode,
                               bool approx = false) {
  uint32_t lf[286];
  memcpy(lf, lf_noeob, sizeof(lf));
  lf[256] += 1;
  plan_dynamic(lf, df, plan, approx);
  uint64_t body =
      huffman_cost_bits(lf, df, plan.dyn.litlen_lens, plan.dyn.dist_lens);
  uint64_t dyn_bits = 3 + plan.header_bits + body;
  const CodeSet& fix = fixed_cs();
  uint64_t fc = huffman_cost_bits(lf, df, fix.litlen_lens, fix.dist_lens);
  uint64_t fix_bits = fc == UINT64_MAX ? UINT64_MAX : 3 + fc;
  size_t blen = m.byte_end - m.byte_begin;
  uint64_t stored_bits =
      ((blen + kMaxStored - 1) / kMaxStored) * 5ull * 8 + blen * 8ull + 7;
  if (stored_bits < dyn_bits && stored_bits < fix_bits) {
    mode = 0;
    return stored_bits;
  }
  if (fix_bits <= dyn_bits) {
    mode = 1;
    return fix_bits;
  }
  mode = 2;
  return dyn_bits;
}

struct SegmentedPlan {
  std::vector<uint32_t> rtoks;   // rewritten tokens (literal runs split)
  std::vector<ChunkMeta> segs;   // final segments, in order
  std::vector<int> modes;        // 0 stored / 1 fixed / 2 dynamic
  std::vector<DynPlan> plans;    // valid where modes[i] == 2
  uint64_t total_bits = 0;
};

// Pass 1: rewrite tokens with literal runs split at chunk boundaries and
// collect per-chunk histograms. Returns the chunk count (0 = segmentation
// not applicable).
static size_t chunk_stats(const uint8_t* src, size_t start, size_t end,
                          const std::vector<uint32_t>& toks, int chunk_shift,
                          std::vector<uint32_t>& rtoks,
                          std::vector<ChunkMeta>& metas,
                          std::vector<uint32_t>& freqs,
                          bool allow_single = false) {
  size_t blen = end - start;
  size_t csize = (size_t)1 << chunk_shift;
  size_t nchunks = (blen + csize - 1) >> chunk_shift;
  if (nchunks == 0 || (nchunks < 2 && !allow_single)) return 0;
  rtoks.clear();
  rtoks.reserve(toks.size() + nchunks);
  metas.assign(nchunks, ChunkMeta{});
  freqs.assign(nchunks * kSegLitDist, 0);

  size_t pos = start;
  size_t c = 0;
  size_t lim = std::min(start + csize, end);
  metas[0].byte_begin = start;
  metas[0].tok_begin = 0;
  // Literal bytes are histogrammed into 4 stripes scoped to the current
  // chunk (merged at chunk close): a single counter array serializes on
  // store-to-load forwarding for repeated bytes, and this pass touches
  // every literal byte of the block.
  alignas(64) uint32_t s0[256] = {0}, s1[256] = {0}, s2[256] = {0},
                       s3[256] = {0};
  bool chunk_open = true;
  auto close_chunk = [&](size_t next_pos) {
    uint32_t* lf = &freqs[c * kSegLitDist];
    for (int s = 0; s < 256; s++) {
      uint32_t v = s0[s] + s1[s] + s2[s] + s3[s];
      if (v) {
        lf[s] += v;
        s0[s] = s1[s] = s2[s] = s3[s] = 0;
      }
    }
    metas[c].byte_end = next_pos;
    metas[c].tok_end = rtoks.size();
    c++;
    if (next_pos < end) {
      metas[c].byte_begin = next_pos;
      metas[c].tok_begin = rtoks.size();
      size_t rel = next_pos - start;
      lim = std::min(start + (((rel >> chunk_shift) + 1) << chunk_shift), end);
    } else {
      chunk_open = false;  // reached end exactly; no successor chunk
    }
  };
  for (uint32_t t : toks) {
    if (t & 0x80000000u) {
      uint32_t l = ((t >> 16) & 0xFF);
      uint32_t dist = (t & 0xFFFF) + 1;
      uint32_t* lf = &freqs[c * kSegLitDist];
      int li = kLenCode.idx[l];
      lf[257 + li]++;
      int di = kDistCode.code(dist);
      lf[286 + di]++;
      metas[c].extra_bits += kLengthExtra[li] + kDistExtra[di];
      metas[c].n_match++;
      rtoks.push_back(t);
      pos += l + 3;
      if (pos >= lim) close_chunk(pos);
    } else {
      size_t run = t;
      while (run) {
        size_t take = std::min(run, lim - pos);
        size_t i = pos;
        for (; i + 4 <= pos + take; i += 4) {
          s0[src[i]]++;
          s1[src[i + 1]]++;
          s2[src[i + 2]]++;
          s3[src[i + 3]]++;
        }
        for (; i < pos + take; i++) s0[src[i]]++;
        metas[c].n_literals += take;
        rtoks.push_back((uint32_t)take);
        pos += take;
        run -= take;
        if (pos >= lim) close_chunk(pos);
      }
    }
  }
  if (chunk_open && c < nchunks && metas[c].byte_begin < pos) close_chunk(pos);
  return c;
}

// Pass 2+3: estimate-driven bottom-up merge over chunk RANGES, then exact
// refinement (merge AND top-down split) against prefix-sum histograms, then
// exact per-segment mode choice. Fills `sp`.
static void merge_and_plan(std::vector<uint32_t>& rtoks,
                           std::vector<ChunkMeta>& metas,
                           std::vector<uint32_t>& freqs, size_t n,
                           SegmentedPlan& sp, bool light = false) {
  // ZT_MPROF=1: per-stage wall times of the segmentation planner (the
  // finer-grained sibling of ZT_PROF's deflate_shared stages).
  static const bool mprof = getenv("ZT_MPROF") != nullptr;
  auto mt0 = std::chrono::steady_clock::now();
  auto mstamp = [&](const char* nm) {
    if (!mprof) return;
    auto now = std::chrono::steady_clock::now();
    fprintf(stderr, "    [mplan] %-8s %.3f ms\n", nm,
            std::chrono::duration<double, std::milli>(now - mt0).count());
    mt0 = now;
  };
  // Prefix sums over the original chunk histograms: any range's histogram
  // is a 316-wide subtraction, so merges and splits never mutate state.
  std::vector<uint32_t> pf((n + 1) * kSegLitDist, 0);
  for (size_t i = 0; i < n; i++)
    for (int s = 0; s < kSegLitDist; s++)
      pf[(i + 1) * kSegLitDist + s] = pf[i * kSegLitDist + s] +
                                      freqs[i * kSegLitDist + s];
  auto range_meta = [&](size_t a, size_t b) {
    ChunkMeta m;
    m.tok_begin = metas[a].tok_begin;
    m.tok_end = metas[b - 1].tok_end;
    m.byte_begin = metas[a].byte_begin;
    m.byte_end = metas[b - 1].byte_end;
    m.extra_bits = 0;
    m.n_literals = 0;
    m.n_match = 0;
    for (size_t i = a; i < b; i++) {
      m.extra_bits += metas[i].extra_bits;
      m.n_literals += metas[i].n_literals;
      m.n_match += metas[i].n_match;
    }
    return m;
  };
  uint32_t tmp[kSegLitDist];
  auto range_hist = [&](size_t a, size_t b) -> const uint32_t* {
    const uint32_t* hi = &pf[b * kSegLitDist];
    const uint32_t* lo = &pf[a * kSegLitDist];
    for (int s = 0; s < kSegLitDist; s++) tmp[s] = hi[s] - lo[s];
    return tmp;
  };
  auto est_range = [&](size_t a, size_t b, bool* sw = nullptr) {
    const uint32_t* h = range_hist(a, b);
    return seg_cost_est(h, h + 286, range_meta(a, b), sw);
  };

  // Estimate phase: greedy best-pair merging over a linked list of ranges
  // while the estimated savings clear a small threshold; borderline pairs
  // stay split for the exact passes below.
  std::vector<int> nxt(n + 1), prv(n + 1);
  std::vector<double> cost(n);
  std::vector<char> stored(n);
  std::vector<double> sav(n, -1e30);  // sav[i]: merge (range i, next range)
  for (size_t i = 0; i < n; i++) {
    nxt[i] = (int)i + 1;
    prv[i] = (int)i - 1;
    bool sw;
    cost[i] = est_range(i, i + 1, &sw);
    stored[i] = sw;
  }
  auto pair_sav = [&](int i) -> double {
    int j = nxt[i];
    if (j >= (int)n) return -1e30;
    int k = nxt[j];
    // Two stored-favorable neighbors always merge (saves a header; avoids
    // leaving incompressible data as hundreds of segments for the exact
    // refinement pass to chew through).
    if (stored[i] && stored[j]) return 1e30;
    return cost[i] + cost[j] - est_range(i, k);
  };
  for (size_t i = 0; i + 1 < n; i++) sav[i] = pair_sav((int)i);
  mstamp("init");

  // Light (BestSpeed) planning trusts the estimate with a wide margin:
  // borderline pairs merge here instead of surviving into the exact sweep,
  // whose per-boundary Huffman builds are the planner's dominant cost at
  // L1 (only clear stored/coded boundaries are worth a header there).
  const double kMergeSlack = light ? 512.0 : 64.0;
  for (;;) {
    int best = -1;
    double best_s = kMergeSlack;
    for (int i = 0; i < (int)n; i = nxt[i]) {
      if (nxt[i] >= (int)n) break;
      if (sav[i] > best_s) {
        best_s = sav[i];
        best = i;
      }
    }
    if (best < 0) break;
    int j = nxt[best];
    nxt[best] = nxt[j];
    if (nxt[j] <= (int)n) prv[nxt[j]] = best;
    bool sw;
    cost[best] = est_range(best, nxt[best], &sw);
    stored[best] = sw;
    sav[best] = pair_sav(best);
    if (prv[best] >= 0) sav[prv[best]] = pair_sav(prv[best]);
  }

  // Exact phase on the surviving ranges [a,b): alternate a merge sweep and
  // a recursive split sweep, both under true package-merge bit counts. The
  // split sweep catches gradually-drifting distributions that fool the
  // greedy pairwise merge (each local merge looks fine; the end-to-end
  // distribution shift does not).
  if (mprof) {
    size_t nr = 0;
    for (int i = 0; i < (int)n; i = nxt[i]) nr++;
    fprintf(stderr, "    [mplan] nchunks=%zu est_ranges=%zu\n", n, nr);
  }
  mstamp("estmerge");
  std::vector<std::pair<size_t, size_t>> ranges;
  for (int i = 0; i < (int)n; i = nxt[i]) ranges.emplace_back(i, nxt[i]);

  DynPlan scratch;
  // Exact evals cost ~5-8 us each (a package-merge per call); the sweeps
  // below re-ask the same ranges repeatedly, so memoize (bits, mode) per
  // (a, b). Plans are only rebuilt for the final segments.
  std::vector<std::pair<uint64_t, int>> memo((n + 1) * 2, {UINT64_MAX, -1});
  std::vector<size_t> memo_b((n + 1) * 2, SIZE_MAX);
  auto exact_range = [&](size_t a, size_t b, DynPlan& plan, int& mode,
                         bool need_plan = false) -> uint64_t {
    size_t slot = a * 2 + (b == a + 1 ? 0 : 1);
    if (!need_plan && memo_b[slot] == b && memo[slot].first != UINT64_MAX) {
      mode = memo[slot].second;
      return memo[slot].first;
    }
    const uint32_t* h = range_hist(a, b);
    // Sweep comparisons use the Kraft-clamped approximation (both sides of
    // every comparison share its small upward bias); only plans that will
    // actually be emitted (need_plan) pay for exact package-merge.
    uint64_t bits = seg_exact_cost(h, h + 286, range_meta(a, b), plan, mode,
                                   /*approx=*/!need_plan);
    if (need_plan) return bits;
    memo_b[slot] = b;
    memo[slot] = {bits, mode};
    return bits;
  };

  // Merge sweep (exact, linear): only when the estimate left boundaries.
  auto merge_sweep = [&]() {
    if (ranges.size() < 2) return;
    std::vector<std::pair<size_t, size_t>> out;
    size_t a = ranges[0].first, b = ranges[0].second;
    int mode_l, mode_r, mode_m;
    uint64_t bits_l = exact_range(a, b, scratch, mode_l);
    for (size_t r = 1; r < ranges.size(); r++) {
      size_t c = ranges[r].second;
      uint64_t bits_r = exact_range(b, c, scratch, mode_r);
      uint64_t bits_m = exact_range(a, c, scratch, mode_m);
      if (bits_m <= bits_l + bits_r) {
        b = c;
        bits_l = bits_m;
      } else {
        out.emplace_back(a, b);
        a = b;
        b = c;
        bits_l = bits_r;
      }
    }
    out.emplace_back(a, b);
    ranges = std::move(out);
  };
  // Light (BestSpeed) planning trusts the estimate end-to-end: the greedy
  // phase above already merged every pair within kMergeSlack=512 estimated
  // bits, so surviving boundaries are est-clear wins and the exact confirm
  // (2-3 Kraft-approx builds at ~9 us each) only re-finds them — measured
  // ~27 us of paper-100k.pdf's 350 us L1 budget for zero ratio change on
  // the corpus. Quality tiers keep the exact sweep.
  if (!light) merge_sweep();
  mstamp("msweep");

  // Split sweep: the cheap estimate ranks every candidate boundary inside a
  // segment; only the best one is verified with exact costs (recursing into
  // the halves on success). This catches gradually-drifting distributions
  // that fool the greedy pairwise merge — each local merge looks fine, the
  // end-to-end shift does not — at ~2 exact evals per accepted split.
  bool split_any = false;
  if (!light) {
    std::vector<std::pair<size_t, size_t>> stack(ranges.rbegin(),
                                                 ranges.rend());
    std::vector<std::pair<size_t, size_t>> done;
    int budget = 256;  // exact-eval backstop
    while (!stack.empty()) {
      auto [a, b] = stack.back();
      stack.pop_back();
      size_t m = b - a;
      bool sw;
      double est_whole = est_range(a, b, &sw);
      if (m < 2 || budget <= 0 || sw) {  // stored never gains from a split
        done.emplace_back(a, b);
        continue;
      }
      size_t stride = m <= 32 ? 1 : (m + 31) / 32;
      double best_est = 1e30;
      size_t best_c = 0;
      for (size_t c = a + stride; c < b; c += stride) {
        double e = est_range(a, c) + est_range(c, b);
        if (e < best_est) {
          best_est = e;
          best_c = c;
        }
      }
      // Verify with exact bits only when the estimate is at least nearly
      // break-even (the estimate's header model is biased low, so a truly
      // profitable split never looks much worse than break-even).
      if (best_c && best_est < est_whole + 96.0) {
        int ml, mr, mw;
        uint64_t bl = exact_range(a, best_c, scratch, ml);
        uint64_t br = exact_range(best_c, b, scratch, mr);
        uint64_t bw = exact_range(a, b, scratch, mw);
        budget -= 3;
        if (bl + br < bw) {
          stack.emplace_back(best_c, b);
          stack.emplace_back(a, best_c);
          split_any = true;
          continue;
        }
      }
      done.emplace_back(a, b);
    }
    ranges = std::move(done);
  }
  mstamp("split");
  if (split_any) merge_sweep();

  // Final exact plans per segment.
  sp.segs.clear();
  // Final exact plans, one package-merge per segment — independent, so they
  // run on the pool (each builds its own histogram; the shared `tmp`
  // scratch in range_hist is not thread-safe).
  sp.segs.resize(ranges.size());
  sp.modes.assign(ranges.size(), 0);
  sp.plans.resize(ranges.size());
  std::vector<uint64_t> rbits(ranges.size(), 0);
  auto final_plan = [&](size_t i) {
    auto [a, b] = ranges[i];
    uint32_t h[kSegLitDist];
    const uint32_t* hi = &pf[b * kSegLitDist];
    const uint32_t* lo = &pf[a * kSegLitDist];
    for (int s = 0; s < kSegLitDist; s++) h[s] = hi[s] - lo[s];
    int mode;
    rbits[i] =
        seg_exact_cost(h, h + 286, range_meta(a, b), sp.plans[i], mode);
    sp.modes[i] = mode;
    sp.segs[i] = range_meta(a, b);
  };
  if (ranges.size() < 8) {
    // A pool round trip costs 50-200 us under virtualization — more than
    // a handful of ~8 us package-merges.
    for (size_t i = 0; i < ranges.size(); i++) final_plan(i);
  } else {
    zt_parallel_for(ranges.size(), final_plan);
  }
  if (mprof) fprintf(stderr, "    [mplan] final_ranges=%zu\n", ranges.size());
  mstamp("final");
  sp.total_bits = 0;
  for (uint64_t b : rbits) sp.total_bits += b;
  sp.rtoks = std::move(rtoks);
}

// Debug/bench knob: ZT_NOSEG=1 disables content-adaptive segmentation.
static bool seg_disabled() {
  static bool v = [] {
    const char* e = getenv("ZT_NOSEG");
    return e && *e && *e != '0';
  }();
  return v;
}

// Top-level segmentation planner over one tokenized region. Returns false
// when segmentation does not apply (fewer than 2 chunks).
static bool plan_segments(const uint8_t* src, size_t start, size_t end,
                          int chunk_shift, const TokenStream& ts,
                          SegmentedPlan& sp) {
  if (seg_disabled()) return false;
  std::vector<uint32_t> rtoks;
  std::vector<ChunkMeta> metas;
  std::vector<uint32_t> freqs;
  size_t n = chunk_stats(src, start, end, ts.tokens, chunk_shift, rtoks,
                         metas, freqs);
  if (n < 2) return false;
  merge_and_plan(rtoks, metas, freqs, n, sp);
  return true;
}

// Emit a segmented plan; marks BFINAL on the last block iff mark_final.
static void emit_segments(BitWriter& bw, const uint8_t* src,
                          const SegmentedPlan& sp, bool mark_final) {
  for (size_t i = 0; i < sp.segs.size(); i++) {
    const ChunkMeta& m = sp.segs[i];
    bool fin = mark_final && (i + 1 == sp.segs.size());
    if (sp.modes[i] == 0) {
      emit_stored(bw, src, m.byte_begin, m.byte_end - m.byte_begin, fin);
    } else {
      bw.add(fin ? 1 : 0, 1);
      bw.add(sp.modes[i] == 1 ? 1 : 2, 2);
      const CodeSet* cs;
      if (sp.modes[i] == 2) {
        emit_dynamic_header(bw, sp.plans[i]);
        cs = &sp.plans[i].dyn;
      } else {
        cs = &fixed_cs();
      }
      emit_tokens_span(bw, src, m.byte_begin, sp.rtoks.data() + m.tok_begin,
                       m.tok_end - m.tok_begin, m.n_literals, m.n_match, *cs,
                       /*emit_eob=*/true);
    }
    if (bw.full) return;
  }
}

// Level-1 segmentation trigger: the BestSpeed path must stay zero-overhead
// on homogeneous text, so segmentation runs only when a free signal says
// the block is mixed — either the match density varies across 32 KiB
// windows (text + embedded binary) or the block is nearly all literals
// (stored/coded boundary territory).
static bool l1_heterogeneous(const TokenStream& ts, size_t blen) {
  if (ts.n_literals >= blen - blen / 20) return true;
  const auto& mb = ts.match_bytes32;
  if (mb.size() < 2) return false;
  double mn = 2.0, mx = -1.0;
  for (size_t i = 0; i < mb.size(); i++) {
    size_t wlen = std::min<size_t>(32768, blen - (i << 15));
    if (wlen < 8192) continue;  // ignore the tiny tail window
    double d = (double)mb[i] / (double)wlen;
    mn = std::min(mn, d);
    mx = std::max(mx, d);
  }
  return mx - mn > 0.25;
}

// Shannon entropy (bits/byte) of the literal histogram with the
// Miller-Madow small-sample bias correction (+ (k-1)/(2 n ln 2)): the
// empirical entropy of genuinely random bytes reads low on small inputs
// (7.986 on 12 KiB), which would send them through the segmentation
// planner instead of the instant stored path.
// log2 of small integers, precomputed: the entropy gates run one log per
// distinct symbol on EVERY block; 256 libm calls were ~4 us per block,
// visible on microsecond inputs. float precision (~1e-7 relative) is far
// inside the 7.99-threshold margin.
static const float* log2_tab() {
  static const float* tab = [] {
    static float t[1 << 16];
    t[0] = 0.0f;
    for (int i = 1; i < (1 << 16); i++) t[i] = (float)__builtin_log2(i);
    return t;
  }();
  return tab;
}
static inline double log2_int(uint64_t v) {
  return v < (1 << 16) ? (double)log2_tab()[v] : __builtin_log2((double)v);
}

static double literal_entropy(const uint32_t* lit_freq, size_t n_literals) {
  if (!n_literals) return 8.0;
  double bits = 0;
  double log2n = log2_int(n_literals);
  double n = (double)n_literals;
  int distinct = 0;
  for (int s = 0; s < 256; s++)
    if (lit_freq[s]) {
      bits += lit_freq[s] * (log2n - log2_int(lit_freq[s]));
      distinct++;
    }
  return bits / n + (distinct - 1) / (2.0 * n * 0.6931471805599453);
}

// Pre-tokenize random-block detector for levels >= 2: full byte histogram
// (corrected entropy) plus a strided mini match-scan. Truly random data
// (no sampled matches, >= 7.99 bits/byte) goes straight to a stored block,
// skipping the hash-chain tokenizer entirely — the chain matcher is at its
// slowest exactly there (every position misses through a full probe).
// The sampler guards against high-byte-entropy-but-LZ-compressible input
// (e.g. a repeated block of random bytes), which must still tokenize.
static bool block_is_random(const uint8_t* src, size_t start, size_t end) {
  size_t n = end - start;
  if (n < 4096) return false;
  // Match sampler first: compressible input almost always trips a sampled
  // match within the first few probes, so the (full-histogram) entropy pass
  // below only ever runs on genuinely match-free data. Every position's
  // 4-gram is INSERTED (cheap hash+store) while only every 16th position
  // probes — insert-sparse sampling detected only repeats whose period is
  // ≡ 0 mod the stride (a >= 20 KiB random block repeated at any other
  // period was misclassified random and emitted STORED at every level).
  // Coprime sparse grids: inserts at stride 11, probes at stride 19. For a
  // repeat at ANY period P there is a probe position p ≡ 0 (mod 19) whose
  // source p-P lands on the insert grid within lcm(11,19)=209 positions
  // (CRT, gcd=1 — the round-3 equal-stride sampler only caught periods
  // ≡ 0 mod the stride), at ~14% of the every-position-insert cost.
  // Entries carry a generation stamp so the 16 KiB table is memset once
  // per THREAD, not per call (this path gates every block of every
  // deflate call; randtest3-class inputs spend their whole budget here).
  // TLS bases are hoisted into locals ONCE: in a dlopen'd shared object
  // thread_local uses general-dynamic TLS, and a per-access __tls_get_addr
  // in the ~2K-iteration probe loop would double this function's cost.
  static thread_local uint32_t table_tls[4096];
  static thread_local uint32_t generation_tls = 0;
  uint32_t* const table = table_tls;
  uint32_t generation = generation_tls;
  auto next_gen = [&]() -> uint32_t {
    if (++generation >= 0xFFFF) {  // stamp field wrapped (or first use)
      memset(table, 0, 4096 * sizeof(uint32_t));
      generation = 1;
    }
    return generation << 16;
  };
  if (generation == 0) memset(table, 0, 4096 * sizeof(uint32_t));
  uint32_t gen = next_gen();
  struct GenSave {
    uint32_t& tls;
    uint32_t& cur;
    ~GenSave() { tls = cur; }
  } gen_save{generation_tls, generation};
  size_t base = start;
  size_t next_ins = start;
  for (size_t p = start; p + 4 <= end; p += 19) {
    for (; next_ins < p; next_ins += 11) {
      if (next_ins - base > 0xF000) {  // keep relative offsets in range
        base = next_ins;
        gen = next_gen();
      }
      uint32_t vi = read32(src + next_ins);
      table[(vi * 0x9E3779B1u) >> 20] = gen | (uint32_t)(next_ins - base);
    }
    uint32_t v = read32(src + p);
    uint32_t h = (v * 0x9E3779B1u) >> 20;
    uint32_t e = table[h];
    if ((e & 0xFFFF0000u) != gen) continue;  // stale entry
    size_t cand = base + (e & 0xFFFF);
    if (cand < p && p - cand <= kWindow && read32(src + cand) == v)
      return false;  // found a sampled match: not random
  }
  // Entropy in two tiers: a stride-2 subsample first (half the reads; the
  // Miller-Madow correction uses the SAMPLE count, so the estimate stays
  // unbiased), full histogram only in the borderline band where the
  // subsample can't call it. Truly random input lands clearly >= 7.99
  // either way; compressible input clearly below — only the rare
  // near-threshold case pays both passes.
  alignas(64) uint32_t h0[256] = {0}, h1[256] = {0}, h2[256] = {0},
                       h3[256] = {0};
  size_t i = start;
  // Two even and two odd offsets per 8-byte group (an all-even sampler
  // sees stride-2-structured data — 16-bit samples with random high bytes
  // and compressible low bytes — at ~8 bits/byte and misclassifies it
  // random). Four independent stripes keep the increment chains out of
  // each other's store-to-load forwarding.
  for (; i + 8 <= end; i += 8) {
    h0[src[i]]++;
    h1[src[i + 1]]++;
    h2[src[i + 4]]++;
    h3[src[i + 5]]++;
  }
  size_t m = 4 * ((end - start) / 8);
  {
    double bits = 0;
    int distinct = 0;
    double dm = (double)m;
    double log2m = log2_int(m);
    for (int s = 0; s < 256; s++) {
      uint32_t f = h0[s] + h1[s] + h2[s] + h3[s];
      if (f) {
        bits += f * (log2m - log2_int(f));
        distinct++;
      }
    }
    double Hs = bits / dm + (distinct - 1) / (2.0 * dm * 0.6931471805599453);
    if (Hs >= 7.996) return true;
    if (Hs < 7.975) return false;
  }
  // Tier 2 completes the histogram with the offsets tier 1 skipped
  // ({2,3,6,7}; tier 1 read {0,1,4,5}), plus the group tail.
  alignas(64) uint32_t g0[256] = {0}, g1[256] = {0}, g2[256] = {0},
                       g3[256] = {0};
  for (i = start; i + 8 <= end; i += 8) {
    g0[src[i + 2]]++;
    g1[src[i + 3]]++;
    g2[src[i + 6]]++;
    g3[src[i + 7]]++;
  }
  for (i = start + 8 * ((end - start) / 8); i < end; i++) g0[src[i]]++;
  double bits = 0;
  int distinct = 0;
  double dn = (double)n;
  double log2n = log2_int(n);
  for (int s = 0; s < 256; s++) {
    uint32_t f = h0[s] + h1[s] + h2[s] + h3[s] + g0[s] + g1[s] + g2[s] +
                 g3[s];
    if (f) {
      bits += f * (log2n - log2_int(f));
      distinct++;
    }
  }
  double H = bits / dn + (distinct - 1) / (2.0 * dn * 0.6931471805599453);
  return H >= 7.99;
}

// Encodes src[enc_start, src_len); bytes before enc_start are window
// history only (for parallel parts and cross-block matches). `sync_end`
// appends an empty non-final stored block and pads to a byte boundary
// (pigz-style sync flush) — required for every NON-FINAL parallel part:
// stored blocks inside a part are byte-aligned relative to the part start,
// so every part must begin on a byte boundary of the global stream.
int64_t deflate_impl(const uint8_t* src, size_t src_len, int level,
                     uint8_t* dst, size_t dst_cap,
                     bool mark_final = true, bool pad_to_byte = true,
                     size_t enc_start = 0, bool sync_end = false) {
  if (level < -2 || level > 9) return ZT_ERR_MALFORMED;
  BitWriter bw(dst, dst_cap);

  if (src_len == enc_start) {
    // single empty block (fixed huffman: just EOB) — or an empty stored block
    bw.add(mark_final ? 1 : 0, 1);
    bw.add(1, 2);
    CodeSet cs;
    fixed_codeset(cs);
    bw.add(cs.litlen_codes[256], cs.litlen_lens[256]);
    size_t out = pad_to_byte ? bw.finish() : bw.finish_bits();
    return bw.full ? ZT_ERR_DST_FULL : (int64_t)out;
  }

  if (level == 0) {
    emit_stored(bw, src, enc_start, src_len - enc_start, mark_final);
    size_t out = pad_to_byte ? bw.finish() : bw.finish_bits();
    return bw.full ? ZT_ERR_DST_FULL : (int64_t)out;
  }

  size_t nblocks = (src_len - enc_start + kMaxBlock - 1) / kMaxBlock;
  for (size_t b = 0; b < nblocks; b++) {
    size_t start = enc_start + b * kMaxBlock;
    size_t end = std::min(start + kMaxBlock, src_len);
    bool final_block = (b == nblocks - 1) && mark_final;

    TokenStream ts;
    if (level == -2) {
      // Huffman-only: one big literal run (reference encodeAllLiterals,
      // deflate.nim:153).
      size_t run = end - start;
      ts.n_literals = run;
      for (size_t i = start; i < end; i++) ts.lit_freq[src[i]]++;
      while (run > 0) {
        uint32_t chunk = run > 0x7FFFFFFF ? 0x7FFFFFFF : (uint32_t)run;
        ts.tokens.push_back(chunk);
        run -= chunk;
      }
      ts.lit_freq[256]++;
    } else {
      int lvl = level == -1 ? 6 : level;
      if (lvl >= 1 && block_is_random(src, start, end)) {
        emit_stored(bw, src, start, end - start, final_block);
        if (bw.full) return ZT_ERR_DST_FULL;
        continue;
      }
      size_t hist_from = start > kWindow ? start - kWindow : 0;
      tokenize(src, start, end, lvl, ts, hist_from);
    }

    // Incompressible shortcut + content-adaptive segmentation. Truly random
    // blocks (>=98% literals at >=7.99 bits/byte) go straight to stored —
    // no chunk of them can code (the reference's >=98%-literal rule,
    // deflate.nim:275-277, tightened). Anything below that (e.g. JPEG with
    // a codable header region at ~7.97 global entropy) reaches the
    // segmentation pass, which splits the block where the symbol
    // distribution shifts or stored beats coded. Segmentation always runs
    // at levels >= 2 (the tokenizer dominates there); at level 1 only when
    // the free heterogeneity signal fires, so BestSpeed text stays
    // single-pass.
    size_t blen_early = end - start;
    double lit_H = -1.0;
    if (level != -2 && ts.n_literals >= blen_early - blen_early / 50) {
      lit_H = literal_entropy(ts.lit_freq, ts.n_literals);
      if (lit_H >= 7.99) {
        emit_stored(bw, src, start, blen_early, final_block);
        if (bw.full) return ZT_ERR_DST_FULL;
        continue;
      }
    }
    if (level != -2) {
      int lvl = level == -1 ? 6 : level;
      bool want = lvl >= 2 || l1_heterogeneous(ts, blen_early);
      if (want) {
        SegmentedPlan sp;
        int shift =
            lvl == 1 ? 13 : (end - start <= 96 * 1024 ? 12 : 13);
        if (plan_segments(src, start, end, shift, ts, sp)) {
          emit_segments(bw, src, sp, final_block);
          if (bw.full) return ZT_ERR_DST_FULL;
          continue;
        }
      }
      // Single-chunk block that is near-all-literals and near-random:
      // stored without a Huffman build (legacy 7.8 bits/byte rule).
      if (lit_H >= 7.8) {
        emit_stored(bw, src, start, blen_early, final_block);
        if (bw.full) return ZT_ERR_DST_FULL;
        continue;
      }
    }

    // Build dynamic codes + header plan.
    DynPlan plan;
    plan_dynamic(ts.lit_freq, ts.dist_freq, plan);
    CodeSet& dyn = plan.dyn;
    uint64_t dyn_bits = 3 + plan.header_bits +
                        huffman_cost_bits(ts, dyn.litlen_lens, dyn.dist_lens);

    CodeSet fix;
    fixed_codeset(fix);
    uint64_t fix_cost = huffman_cost_bits(ts, fix.litlen_lens, fix.dist_lens);
    uint64_t fix_bits = fix_cost == UINT64_MAX ? UINT64_MAX : 3 + fix_cost;

    size_t blen = end - start;
    uint64_t stored_bits =
        ((blen + kMaxStored - 1) / kMaxStored) * 5ull * 8 + blen * 8ull + 7;

    if (stored_bits < dyn_bits && stored_bits < fix_bits && level != -2) {
      emit_stored(bw, src, start, blen, final_block);
    } else if (fix_bits <= dyn_bits) {
      bw.add(final_block ? 1 : 0, 1);
      bw.add(1, 2);
      emit_tokens(bw, src, start, ts, fix);
    } else {
      bw.add(final_block ? 1 : 0, 1);
      bw.add(2, 2);
      emit_dynamic_header(bw, plan);
      emit_tokens(bw, src, start, ts, dyn);
    }
    if (bw.full) return ZT_ERR_DST_FULL;
  }
  if (sync_end) {
    // Empty non-final stored block: BFINAL=0, BTYPE=00, pad, LEN=0, NLEN.
    bw.add(0, 3);
    bw.align_byte();
    bw.add(0, 16);
    bw.add(0xFFFF, 16);
  }
  size_t out = pad_to_byte ? bw.finish() : bw.finish_bits();
  return bw.full ? ZT_ERR_DST_FULL : (int64_t)out;
}

// ---------------------------------------------------------------------------
// Multi-threaded deflate: split the input at 64 KiB-aligned boundaries, run
// deflate_impl per part on a thread (LZ77 state never crosses parts, like the
// reference's independent 4 MiB blocks, deflate.nim:228-237), then splice the
// per-part bit streams. Output differs from 1-thread output (window resets at
// part boundaries) but is a valid stream; threshold keeps the ratio cost tiny.
// ---------------------------------------------------------------------------

const size_t kMtMinInput = 32 * 1024;    // don't thread below this
const size_t kMtMinPart = 16 * 1024;     // at least this many bytes per part

// Persistent worker pool: spawning std::thread costs 30-80 us, which
// dominates sub-millisecond parts. Workers are created once; the caller
// thread always runs part 0 itself.
class WorkerPool {
 public:
  static WorkerPool& instance() {
    static WorkerPool pool;
    return pool;
  }

  // Run fn(0..n-1); fn(0) on the calling thread, the rest on workers.
  // Completion uses a bounded spin before blocking: condvar round-trips
  // cost tens of microseconds under virtualization, comparable to a whole
  // sub-millisecond part.
  void parallel_for(size_t n, const std::function<void(size_t)>& fn) {
    if (n <= 1) {
      if (n == 1) fn(0);
      return;
    }
    // Dynamic dispatch: every participant (the calling thread AND each
    // helper) pulls the next index from a shared counter until the range
    // is drained. This balances unequal task costs and, crucially, keeps
    // the caller working when n exceeds the worker count (the pool has
    // hw-1 workers; the caller is the remaining core).
    auto state = std::make_shared<ParState>();
    state->fn = &fn;
    state->n = n;
    size_t helpers = std::min(workers_.size(), n - 1);
    {
      std::lock_guard<std::mutex> lk(m_);
      for (size_t w = 0; w < helpers; w++)
        q_.push_back([state, this] {
          run_par(*state);
          std::lock_guard<std::mutex> lk2(done_m_);
          done_cv_.notify_all();
        });
    }
    pending_.store(true, std::memory_order_release);
    cv_.notify_all();
    run_par(*state);  // caller participates
    for (int spin = 0; spin < 4000; spin++) {
      if (state->done.load(std::memory_order_acquire) == n) return;
      __builtin_ia32_pause();
    }
    std::unique_lock<std::mutex> lk(done_m_);
    done_cv_.wait(lk, [&] { return state->done.load() == n; });
  }

  struct ParState {
    const std::function<void(size_t)>* fn = nullptr;
    size_t n = 0;
    std::atomic<size_t> next{0};
    std::atomic<size_t> done{0};
  };

  void run_par(ParState& st) {
    for (;;) {
      size_t i = st.next.fetch_add(1);
      if (i >= st.n) return;
      (*st.fn)(i);
      st.done.fetch_add(1);
    }
  }

 private:
  WorkerPool() {
    unsigned hw = std::thread::hardware_concurrency();
    size_t nworkers = hw > 1 ? hw - 1 : 1;
    for (size_t i = 0; i < nworkers; i++)
      workers_.emplace_back([this] { worker_loop(); });
  }
  ~WorkerPool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  // Post-task spin window before a worker blocks on the condvar. A condvar
  // wakeup costs 50-200 us under virtualization — more than an entire phase
  // of a sub-millisecond encode. The window is sized to bridge the SERIAL
  // stretches between a call's parallel phases (merge + plan between
  // tokenize and emit) and back-to-back calls in a pipeline, so the worker
  // is still awake when the next phase fans out. ZT_SPIN_US overrides.
  static int spin_us() {
    static int v = [] {
      const char* e = getenv("ZT_SPIN_US");
      if (e && *e) {
        long x = strtol(e, nullptr, 10);
        if (x >= 0 && x <= 1000000) return (int)x;
      }
      return 500;
    }();
    return v;
  }

  void worker_loop() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(m_);
        if (q_.empty() && !stop_) {
          // Bounded spin for freshly-enqueued work before sleeping.
          lk.unlock();
          auto deadline = std::chrono::steady_clock::now() +
                          std::chrono::microseconds(spin_us());
          while (!pending_.load(std::memory_order_acquire)) {
            for (int k = 0; k < 64; k++) __builtin_ia32_pause();
            if (std::chrono::steady_clock::now() >= deadline) break;
          }
          lk.lock();
        }
        cv_.wait(lk, [&] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        task = std::move(q_.front());
        q_.pop_front();
        pending_.store(!q_.empty(), std::memory_order_release);
      }
      task();
    }
  }
  std::mutex m_, done_m_;
  std::condition_variable cv_, done_cv_;
  std::deque<std::function<void()>> q_;
  std::vector<std::thread> workers_;
  std::atomic<bool> pending_{false};
  bool stop_ = false;
};

void zt_parallel_for(size_t n, const std::function<void(size_t)>& fn) {
  WorkerPool::instance().parallel_for(n, fn);
}

size_t deflate_bound(size_t n) {
  // n/6 slack covers HuffmanOnly (level -2) on incompressible data, which
  // cannot fall back to stored blocks (fixed literal codes are <= 9 bits,
  // so worst case is 9/8 = 1.125x plus per-block headers).
  return n + n / 6 + (n / kMaxStored + 1) * 5 + 256;
}

unsigned zt_num_threads() {
  static unsigned n = [] {
    const char* e = getenv("ZT_THREADS");
    if (e && *e) {
      long v = strtol(e, nullptr, 10);
      if (v >= 1 && v <= 256) return (unsigned)v;
    }
    unsigned hw = std::thread::hardware_concurrency();
    return hw ? hw : 1u;
  }();
  return n;
}

// Recompute a unit's TokenStream histograms from its (edited) tokens.
static void rebuild_ts_stats(const uint8_t* src, size_t start,
                             TokenStream& ts) {
  memset(ts.lit_freq, 0, sizeof(ts.lit_freq));
  memset(ts.dist_freq, 0, sizeof(ts.dist_freq));
  ts.n_literals = 0;
  ts.n_tokens_match = 0;
  size_t pos = start;
  for (uint32_t t : ts.tokens) {
    if (t & 0x80000000u) {
      uint32_t l = (t >> 16) & 0xFF;
      ts.lit_freq[257 + kLenCode.idx[l]]++;
      ts.dist_freq[kDistCode.code((t & 0xFFFF) + 1)]++;
      ts.n_tokens_match++;
      pos += l + 3;
    } else {
      for (uint32_t i = 0; i < t; i++) ts.lit_freq[src[pos + i]]++;
      ts.n_literals += t;
      pos += t;
    }
  }
  ts.lit_freq[256]++;
}

// Shared-planning parallel deflate for inputs up to one encoder block
// (4 MiB): tokenize fixed 32 KiB work units in parallel (unit count depends
// only on input size, so output is BYTE-IDENTICAL at every thread count),
// merge the per-unit chunk statistics, run ONE global content-adaptive
// segmentation plan, then emit segments — large ones split at token
// boundaries — in parallel and splice at exact bit positions. Compared to
// per-part independent planning this never duplicates near-identical code
// tables across parts and never pays forced part-boundary segment breaks;
// the only multi-thread ratio cost left is the per-unit tokenizer seam
// (a unit cannot extend a match past its end), a few bytes per seam.
int64_t deflate_shared(const uint8_t* src, size_t src_len, int level,
                       uint8_t* dst, size_t dst_cap) {
#define ZT_TS(name)                                                       \
  if (prof) {                                                             \
    auto now = std::chrono::steady_clock::now();                          \
    fprintf(stderr, "  [prof] %-10s %.3f ms\n", name,                     \
            std::chrono::duration<double, std::milli>(now - prof_t).count()); \
    prof_t = now;                                                         \
  }
  static const bool prof = getenv("ZT_PROF") != nullptr;
  auto prof_t = std::chrono::steady_clock::now();
  int lvl = level == -1 ? 6 : level;
  BitWriter bw(dst, dst_cap);
  if (lvl >= 1 && block_is_random(src, 0, src_len)) {
    emit_stored(bw, src, 0, src_len, true);
    size_t out = bw.finish();
    return bw.full ? ZT_ERR_DST_FULL : (int64_t)out;
  }

  ZT_TS("rand")
  // Chunk granularity: 4 KiB chunks when the planner can afford them
  // (small inputs have few chunks; large inputs amortize the planning) —
  // 8 KiB in the 96-256 KiB band, where near-quadratic planner cost lands
  // on the most latency-sensitive sizes and coarse boundaries already
  // capture the structure.
  const int shift =
      lvl == 1 ? 14
               : ((src_len <= 96 * 1024 ||
                   (src_len > 256 * 1024 && src_len <= 512 * 1024))
                      ? 12
                      : 13);
  // Work units: ~32 KiB apiece, rounded to an EVEN count (so 2^k-thread
  // hosts divide them cleanly), each a whole number of chunks. The layout
  // depends only on input size — output is byte-identical at every thread
  // count.
  const size_t csize = (size_t)1 << shift;
  size_t nu = (src_len + 64 * 1024 - 1) / (64 * 1024) * 2;
  // 4 KiB grain rounding (not csize): csize-rounding turned a 100 KiB
  // input into 32/32/32/5 KiB units — a 64/37 split across 2 cores; unit
  // tails simply end with a short chunk (chunk_stats allows it).
  size_t grain = ((src_len + nu - 1) / nu + 4095) & ~(size_t)4095;
  const size_t nunits = (src_len + grain - 1) / grain;

  struct UnitOut {
    TokenStream ts;
    std::vector<uint32_t> rtoks;
    std::vector<ChunkMeta> metas;
    std::vector<uint32_t> freqs;
    size_t nch = 0;
  };
  std::vector<UnitOut> uo(nunits);
  std::vector<size_t> ustarts(nunits);
  WorkerPool& pool = WorkerPool::instance();
  // Round 1: tokenize, and (when segmentation planning is level policy,
  // lvl >= 2) chunk statistics, fused in one pool round. At BestSpeed the
  // heterogeneity gate is decided after tokenization, so chunk stats only
  // run in the rare mixed-content case (second round below).
  const bool seg_policy = lvl >= 2;
  pool.parallel_for(nunits, [&](size_t u) {
    size_t ustart = u * grain;
    size_t uend = std::min(ustart + grain, src_len);
    size_t hist_from = ustart > (size_t)kWindow ? ustart - kWindow : 0;
    ustarts[u] = ustart;
    tokenize(src, ustart, uend, lvl, uo[u].ts, hist_from);
    if (seg_policy)
      uo[u].nch = chunk_stats(src, ustart, uend, uo[u].ts.tokens, shift,
                              uo[u].rtoks, uo[u].metas, uo[u].freqs,
                              /*allow_single=*/true);
  });

  ZT_TS("round1")
  // Seam repair (serial): a unit cannot extend its final match past its
  // end, so runs and long matches break at every unit boundary (a unit of
  // zeros ends with orphan literals the next unit's matcher would have
  // covered, and the next unit restarts its match phase). Extend the last
  // match of each unit as far as the data allows — across MULTIPLE units
  // for long runs — re-split the covered span into maximal match tokens,
  // and trim the consumed bytes off the following units' token streams
  // (a shortened match keeps its distance; remnants under 3 bytes become
  // literals). After this pass the token stream matches what a single
  // serial tokenizer would emit at run boundaries.
  std::vector<size_t> uends(nunits);
  std::vector<char> dirty(nunits, 0);
  for (size_t u = 0; u < nunits; u++)
    uends[u] = std::min((u + 1) * grain, src_len);
  for (size_t u = 0; u + 1 < nunits; u++) {
    auto& toks = uo[u].ts.tokens;
    if (toks.empty()) continue;
    size_t uend = uends[u];
    uint32_t last = toks.back();
    size_t len;
    uint32_t dist;
    if (last & 0x80000000u) {
      len = ((last >> 16) & 0xFF) + 3;
      dist = (last & 0xFFFF) + 1;
    } else if (last < 128 && toks.size() >= 2 &&
               (toks[toks.size() - 2] & 0x80000000u)) {
      // Trailing literal run (e.g. the 2-byte remnant of a long run that
      // hit the unit end): if the previous match's distance also covers
      // the run, it can seed a cross-seam match.
      uint32_t run = last;
      dist = (toks[toks.size() - 2] & 0xFFFF) + 1;
      if ((size_t)dist > uend - run) continue;
      bool covers = true;
      for (size_t q = uend - run; q < uend; q++)
        if (src[q] != src[q - dist]) {
          covers = false;
          break;
        }
      if (!covers) continue;
      len = run;
    } else {
      continue;
    }
    size_t p = uend;
    while (p < src_len && src[p] == src[p - dist]) p++;
    size_t ext = p - uend;
    if (!ext || len + ext < 3) continue;
    // Small extensions barely change the stream (the next unit re-covers
    // those bytes with its own matches at ~equal cost) but would force a
    // statistics rebuild of both units; only long continuations — runs —
    // are worth repairing.
    if (ext < 64) continue;
    // Re-split [uend - len, uend + ext) into maximal matches.
    toks.pop_back();
    size_t total = len + ext;
    // Greedy split exactly as a serial tokenizer would: maximal matches,
    // and a 1-2 byte tail as literals (the literal is already in the tree;
    // a forced short match would add a fresh length symbol to the header).
    for (size_t k = 0; k < total / (size_t)kMaxMatch; k++)
      toks.push_back(0x80000000u | ((uint32_t)(kMaxMatch - 3) << 16) |
                     (dist - 1));
    size_t r = total % (size_t)kMaxMatch;
    if (r > 3)
      toks.push_back(0x80000000u | ((uint32_t)(r - 3) << 16) | (dist - 1));
    else if (r)
      toks.push_back((uint32_t)r);  // 1-3 byte tail as literals: a len-3
                                    // match would add a fresh length symbol
                                    // to the tree for ~no body savings
    uends[u] = uend + ext;
    dirty[u] = 1;
    // Consume `ext` bytes from the front of the following units.
    size_t e = ext;
    for (size_t v = u + 1; v < nunits && e > 0; v++) {
      size_t avail = uends[v] - ustarts[v];
      size_t take_v = std::min(e, avail);
      auto& nt = uo[v].ts.tokens;
      size_t drop = 0;
      size_t ev = take_v;
      uint32_t partial[1];
      int npartial = 0;
      for (size_t t = 0; t < nt.size() && ev > 0; t++) {
        uint32_t tok = nt[t];
        size_t tb = (tok & 0x80000000u) ? (((tok >> 16) & 0xFF) + 3) : tok;
        if (tb <= ev) {
          ev -= tb;
          drop++;
        } else {
          size_t rem = tb - ev;
          if (tok & 0x80000000u) {
            partial[0] = rem >= 3
                             ? (0x80000000u | ((uint32_t)(rem - 3) << 16) |
                                (tok & 0xFFFF))
                             : (uint32_t)rem;
          } else {
            partial[0] = (uint32_t)rem;
          }
          npartial = 1;
          ev = 0;
          drop++;
        }
      }
      nt.erase(nt.begin(), nt.begin() + drop);
      if (npartial) nt.insert(nt.begin(), partial[0]);
      ustarts[v] += take_v;
      e -= take_v;
      dirty[v] = 1;
    }
  }

  ZT_TS("repair")
  // Dirty units (those the seam repair touched): refresh their TokenStream
  // histograms; on most inputs no unit is dirty at all.
  for (size_t u = 0; u < nunits; u++)
    if (dirty[u]) rebuild_ts_stats(src, ustarts[u], uo[u].ts);

  // BestSpeed heterogeneity gate, decided on the repaired token streams:
  // homogeneous text skips chunk statistics and segmentation entirely.
  bool want_seg = seg_policy;
  size_t n_literals_all = 0;
  for (auto& u : uo) n_literals_all += u.ts.n_literals;
  if (!want_seg) {
    if (n_literals_all >= src_len - src_len / 20) {
      want_seg = true;
    } else {
      double mn = 2.0, mx = -1.0;
      for (size_t u = 0; u < nunits; u++) {
        size_t ulen = uends[u] - ustarts[u];
        if (ulen < 8192) continue;
        uint64_t mbytes = 0;
        for (uint32_t v : uo[u].ts.match_bytes32) mbytes += v;
        double d = (double)mbytes / (double)ulen;
        mn = std::min(mn, d);
        mx = std::max(mx, d);
      }
      want_seg = mx - mn > 0.25;
    }
  }

  // Chunk statistics for units that still need them: all units at L1 when
  // heterogeneous, just the dirty ones otherwise.
  {
    std::vector<size_t> redo;
    for (size_t u = 0; u < nunits; u++)
      if (want_seg && (dirty[u] || !seg_policy)) redo.push_back(u);
    if (!redo.empty())
      pool.parallel_for(redo.size(), [&](size_t i) {
        size_t u = redo[i];
        uo[u].rtoks.clear();
        uo[u].metas.clear();
        uo[u].freqs.clear();
        uo[u].nch =
            chunk_stats(src, ustarts[u], uends[u], uo[u].ts.tokens, shift,
                        uo[u].rtoks, uo[u].metas, uo[u].freqs,
                        /*allow_single=*/true);
      });
  }

  ZT_TS("cs2")
  // Merge unit statistics into one global chunk sequence.
  std::vector<uint32_t> rtoks;
  std::vector<ChunkMeta> metas;
  std::vector<uint32_t> freqs;
  uint32_t lit[286] = {0};
  uint32_t dfreq[30] = {0};
  size_t n_literals = 0, n_match_tokens = 0;
  if (want_seg) {
    size_t total_rt = 0, total_ch = 0;
    for (auto& u : uo) {
      total_rt += u.rtoks.size();
      total_ch += u.nch;
    }
    rtoks.reserve(total_rt);
    metas.reserve(total_ch);
    freqs.reserve(total_ch * kSegLitDist);
    for (auto& u : uo) {
      size_t off = rtoks.size();
      rtoks.insert(rtoks.end(), u.rtoks.begin(), u.rtoks.end());
      for (size_t c = 0; c < u.nch; c++) {
        ChunkMeta m = u.metas[c];
        m.tok_begin += off;
        m.tok_end += off;
        metas.push_back(m);
      }
      freqs.insert(freqs.end(), u.freqs.begin(),
                   u.freqs.begin() + u.nch * kSegLitDist);
    }
  }
  for (auto& u : uo) {
    for (int i = 0; i < 286; i++) lit[i] += u.ts.lit_freq[i];
    for (int i = 0; i < 30; i++) dfreq[i] += u.ts.dist_freq[i];
    n_literals += u.ts.n_literals;
    n_match_tokens += u.ts.n_tokens_match;
  }
  lit[256] = 1;  // single EOB in the merged single-block view
  size_t nch = metas.size();

  ZT_TS("mergestat")
  // Truly-random stored shortcut (mirrors deflate_impl).
  if (n_literals >= src_len - src_len / 50 &&
      literal_entropy(lit, n_literals) >= 7.99) {
    emit_stored(bw, src, 0, src_len, true);
    size_t out = bw.finish();
    return bw.full ? ZT_ERR_DST_FULL : (int64_t)out;
  }

  ZT_TS("shortcut")
  SegmentedPlan sp;
  bool has_sp = false;
  if (want_seg && nch >= 2) {
    // BestSpeed planning skips the recursive split sweep: merges alone
    // capture the stored/coded boundaries that matter at L1.
    merge_and_plan(rtoks, metas, freqs, nch, sp, /*light=*/lvl == 1);
    has_sp = !sp.segs.empty();
  }

  ZT_TS("plan")
  struct EmitU {
    int seg;           // index into sp.segs, or -1 for single-block mode
    size_t t0, t1;     // token span [t0, t1) in the span's token array
    size_t byte0;      // source byte position of the first token
    size_t nlit, nmat; // literal bytes / match tokens in the span
    int mode;          // 0 stored / 1 fixed / 2 dynamic
    bool header, eob, fin;
    size_t bytes = 0;           // source bytes covered by the span
    const uint32_t* toks = nullptr;  // token array this span indexes
  };
  std::vector<EmitU> eus;
  const uint32_t* emit_toks = rtoks.data();
  DynPlan single_plan;
  int single_mode = 0;
  // Emission pieces come from precomputed boundaries (chunk metas or unit
  // streams) — NOT from walking tokens, which costs real time on large
  // token streams. All pieces of one segment share its code set, so the
  // emitted bits are identical to a serial emission.
  const size_t kEmitGrain = 96 * 1024;

  if (has_sp) {
    emit_toks = sp.rtoks.data();
    size_t ci = 0;  // cursor into the global chunk metas
    for (size_t i = 0; i < sp.segs.size(); i++) {
      const ChunkMeta& m = sp.segs[i];
      bool fin = i + 1 == sp.segs.size();
      if (sp.modes[i] == 0) {
        eus.push_back({(int)i, 0, 0, m.byte_begin, 0, 0, 0, true, false, fin});
        while (ci < nch && metas[ci].tok_end <= m.tok_end) ci++;
        continue;
      }
      // Group this segment's chunks into >= kEmitGrain-byte pieces.
      bool first = true;
      while (ci < nch && metas[ci].tok_begin < m.tok_end) {
        EmitU U{(int)i, metas[ci].tok_begin, metas[ci].tok_end,
                metas[ci].byte_begin, metas[ci].n_literals, metas[ci].n_match,
                sp.modes[i], first, false, fin};
        size_t bytes = metas[ci].byte_end - metas[ci].byte_begin;
        ci++;
        while (ci < nch && metas[ci].tok_begin < m.tok_end &&
               bytes < kEmitGrain) {
          U.t1 = metas[ci].tok_end;
          U.nlit += metas[ci].n_literals;
          U.nmat += metas[ci].n_match;
          bytes += metas[ci].byte_end - metas[ci].byte_begin;
          ci++;
        }
        U.eob = !(ci < nch && metas[ci].tok_begin < m.tok_end);
        U.bytes = bytes;
        eus.push_back(U);
        first = false;
      }
    }
  } else {
    // Single block over the whole input: choose stored/fixed/dynamic by
    // exact cost on the merged histograms.
    plan_dynamic(lit, dfreq, single_plan);
    uint64_t dyn_bits =
        3 + single_plan.header_bits +
        huffman_cost_bits(lit, dfreq, single_plan.dyn.litlen_lens,
                          single_plan.dyn.dist_lens);
    const CodeSet& fix = fixed_cs();
    uint64_t fc = huffman_cost_bits(lit, dfreq, fix.litlen_lens, fix.dist_lens);
    uint64_t fix_bits = fc == UINT64_MAX ? UINT64_MAX : 3 + fc;
    uint64_t stored_bits =
        ((src_len + kMaxStored - 1) / kMaxStored) * 5ull * 8 + src_len * 8ull +
        7;
    if (stored_bits < dyn_bits && stored_bits < fix_bits) {
      emit_stored(bw, src, 0, src_len, true);
      size_t out = bw.finish();
      return bw.full ? ZT_ERR_DST_FULL : (int64_t)out;
    }
    single_mode = fix_bits <= dyn_bits ? 1 : 2;
    // One emission piece per unit, pointing straight at the unit's token
    // stream: no concatenation, no token walk.
    bool first = true;
    for (size_t u = 0; u < nunits; u++) {
      if (uo[u].ts.tokens.empty() && uends[u] == ustarts[u]) continue;
      EmitU U{-1, 0, uo[u].ts.tokens.size(), ustarts[u],
              uo[u].ts.n_literals, uo[u].ts.n_tokens_match, single_mode,
              first, false, true};
      U.bytes = uends[u] - ustarts[u];
      U.toks = uo[u].ts.tokens.data();
      eus.push_back(U);
      first = false;
    }
    if (!eus.empty()) eus.back().eob = true;
  }

  if (getenv("ZT_DUMP")) {
    fprintf(stderr, "nunits=%zu nch=%zu segs=%zu has_sp=%d\n", nunits, nch,
            sp.segs.size(), (int)has_sp);
    for (size_t c = 0; c < nch; c++)
      fprintf(stderr, "chunk %zu tok[%u,%u) byte[%zu,%zu)\n", c,
              (unsigned)metas[c].tok_begin, (unsigned)metas[c].tok_end,
              metas[c].byte_begin, metas[c].byte_end);
    for (size_t i = 0; i < sp.segs.size(); i++)
      fprintf(stderr, "seg %zu mode %d tok[%u,%u) byte[%zu,%zu)\n", i,
              sp.modes[i], (unsigned)sp.segs[i].tok_begin,
              (unsigned)sp.segs[i].tok_end, sp.segs[i].byte_begin,
              sp.segs[i].byte_end);
    for (size_t e = 0; e < eus.size(); e++)
      fprintf(stderr,
              "eu %zu seg %d mode %d t[%zu,%zu) byte0 %zu bytes %zu hdr %d "
              "eob %d fin %d\n",
              e, eus[e].seg, eus[e].mode, eus[e].t0, eus[e].t1, eus[e].byte0,
              eus[e].bytes, (int)eus[e].header, (int)eus[e].eob,
              (int)eus[e].fin);
  }
  for (auto& U : eus)
    if (!U.toks) U.toks = emit_toks;
  ZT_TS("build_eus")
  struct RawBuf {
    std::unique_ptr<uint8_t[]> p;
    size_t n = 0;
    void alloc(size_t sz) {
      p.reset(new uint8_t[sz]);
      n = sz;
    }
    uint8_t* data() { return p.get(); }
    size_t size() const { return n; }
  };
  std::vector<RawBuf> ebufs(eus.size());
  std::vector<int64_t> ebits(eus.size(), 0);
  pool.parallel_for(eus.size(), [&](size_t e) {
    const EmitU& U = eus[e];
    size_t span_bytes;
    if (U.mode == 0) {
      const ChunkMeta& m = sp.segs[U.seg];
      span_bytes = m.byte_end - m.byte_begin;
    } else {
      span_bytes = U.bytes;
    }
    // 15-bit worst-case literals under a shared code + header slack.
    ebufs[e].alloc(2 * span_bytes + 1024);
    BitWriter pbw(ebufs[e].data(), ebufs[e].size());
    if (U.mode == 0) {
      const ChunkMeta& m = sp.segs[U.seg];
      emit_stored(pbw, src, m.byte_begin, m.byte_end - m.byte_begin, U.fin);
    } else {
      const CodeSet& cs =
          U.seg < 0 ? (single_mode == 1 ? fixed_cs() : single_plan.dyn)
                    : (U.mode == 1 ? fixed_cs() : sp.plans[U.seg].dyn);
      if (U.header) {
        pbw.add(U.fin ? 1 : 0, 1);
        pbw.add(U.mode == 1 ? 1 : 2, 2);
        if (U.mode == 2)
          emit_dynamic_header(pbw, U.seg < 0 ? single_plan : sp.plans[U.seg]);
      }
      emit_tokens_span(pbw, src, U.byte0, U.toks + U.t0, U.t1 - U.t0,
                       U.nlit, U.nmat, cs, /*emit_eob=*/U.eob);
    }
    ebits[e] = pbw.full ? ZT_ERR_DST_FULL : (int64_t)pbw.finish_bits();
  });

  ZT_TS("emit")
  for (size_t e = 0; e < eus.size(); e++) {
    if (ebits[e] < 0) return ebits[e];
    if (e > 0 && eus[e].mode == 0 && bw.bit_pos_in_byte() != 0) {
      // Sync flush so the stored block's internal byte alignment (computed
      // piece-locally) matches the stream. Emitted here by the splicing
      // writer, which knows the true bit phase.
      bw.add(0, 3);
      bw.align_byte();
      bw.add(0, 16);
      bw.add(0xFFFF, 16);
    }
    bw.append_stream(ebufs[e].data(), (size_t)ebits[e]);
  }
  ZT_TS("splice")
  size_t out = bw.finish();
  return bw.full ? ZT_ERR_DST_FULL : (int64_t)out;
}

int64_t deflate_mt(const uint8_t* src, size_t src_len, int level, uint8_t* dst,
                   size_t dst_cap) {
  // Effort scaling: at the default level, small inputs get the optimal
  // parse (level 7's budget DP) — a few ms at most at this size, and it
  // compresses ~2-3% smaller than the lazy parse (strictly below zlib -6,
  // where lazy alone leaves a handful of bytes on dense small files).
  if ((level == 6 || level == -1) && src_len <= 36 * 1024) level = 7;
  if (level == 0 || src_len < kMtMinInput)
    return deflate_impl(src, src_len, level, dst, dst_cap);
  // Shared-planning path is used at EVERY thread count (unit layout depends
  // only on input size), so output is byte-identical under any ZT_THREADS.
  if (src_len <= kMaxBlock && level != -2)
    return deflate_shared(src, src_len, level, dst, dst_cap);
  unsigned hw = zt_num_threads();
  size_t max_parts = std::min<size_t>(hw, src_len / kMtMinPart);
  if (max_parts < 2)
    return deflate_impl(src, src_len, level, dst, dst_cap);

  size_t nparts = max_parts;
  size_t part = ((src_len / nparts) + 0xFFF) & ~(size_t)0xFFF;
  nparts = (src_len + part - 1) / part;
  if (nparts < 2) return deflate_impl(src, src_len, level, dst, dst_cap);

  // Uninitialized per-part scratch (vector::resize would memset ~2x the
  // input size, a measurable slice of sub-5ms encodes).
  struct RawBuf {
    std::unique_ptr<uint8_t[]> p;
    size_t n = 0;
    void alloc(size_t sz) {
      p.reset(new uint8_t[sz]);
      n = sz;
    }
    uint8_t* data() { return p.get(); }
    size_t size() const { return n; }
  };
  std::vector<RawBuf> bufs(nparts);
  std::vector<int64_t> nbits(nparts, 0);
  WorkerPool& pool = WorkerPool::instance();

  for (size_t t = 0; t < nparts; t++)
    bufs[t].alloc(deflate_bound(std::min(part, src_len - t * part)) + 8);
  pool.parallel_for(nparts, [&](size_t t) {
    size_t start = t * part;
    size_t end = std::min(start + part, src_len);
    // All parts return exact bit counts; only BFINAL marking differs.
    // The whole buffer is shared read-only: each part sees the previous
    // 32 KiB as match history, so the split costs almost no ratio.
    // Non-final parts sync-flush so every part starts byte-aligned
    // (stored blocks inside a part depend on it).
    bool final_part = t == nparts - 1;
    nbits[t] = deflate_impl(src, end, level, bufs[t].data(),
                            bufs[t].size(), final_part, false, start,
                            /*sync_end=*/!final_part);
  });

  BitWriter bw(dst, dst_cap);
  for (size_t t = 0; t < nparts; t++) {
    if (nbits[t] < 0) return nbits[t];
    bw.append_stream(bufs[t].data(), (size_t)nbits[t]);
  }
  size_t out = bw.finish();
  return bw.full ? ZT_ERR_DST_FULL : (int64_t)out;
}

// ---------------------------------------------------------------------------
// One-call container codecs (gzip member / zlib wrapper): header parse +
// codec + checksum verification in a single native call, so small inputs
// don't pay multiple FFI crossings. Framing semantics per RFC 1952/1950
// (reference gzip.nim, zippy.nim:61-78,130-162).
// ---------------------------------------------------------------------------

enum {
  ZT_ERR_CHECKSUM = -3,
  ZT_ERR_SIZE = -4,
};

int64_t gzip_uncompress_impl(const uint8_t* src, size_t src_len, uint8_t* dst,
                             size_t dst_cap, size_t* consumed) {
  if (src_len < 18) return ZT_ERR_MALFORMED;
  if (src[0] != 0x1F || src[1] != 0x8B) return ZT_ERR_MALFORMED;
  if (src[2] != 8) return ZT_ERR_MALFORMED;
  uint8_t flg = src[3];
  if (flg & 0xE0) return ZT_ERR_MALFORMED;
  size_t p = 10;
  if (flg & 4) {  // FEXTRA
    if (p + 2 > src_len) return ZT_ERR_MALFORMED;
    uint16_t xlen;
    memcpy(&xlen, src + p, 2);
    p += 2 + xlen;
    if (p > src_len) return ZT_ERR_MALFORMED;
  }
  if (flg & 8) {  // FNAME
    while (p < src_len && src[p]) p++;
    if (p++ >= src_len) return ZT_ERR_MALFORMED;
  }
  if (flg & 16) {  // FCOMMENT
    while (p < src_len && src[p]) p++;
    if (p++ >= src_len) return ZT_ERR_MALFORMED;
  }
  if (flg & 2) {  // FHCRC (not verified; reference gzip.nim:55-59 skips too)
    p += 2;
    if (p >= src_len) return ZT_ERR_MALFORMED;
  }
  if (p + 8 >= src_len) return ZT_ERR_MALFORMED;
  size_t end_bit = 0;
  int64_t n = inflate_impl(src, src_len, p * 8, dst, dst_cap, &end_bit);
  if (n < 0) return n;
  size_t tpos = (end_bit + 7) / 8;
  if (tpos + 8 > src_len) return ZT_ERR_MALFORMED;
  uint32_t want_crc, want_isize;
  memcpy(&want_crc, src + tpos, 4);
  memcpy(&want_isize, src + tpos + 4, 4);
  if (crc32(dst, (size_t)n) != want_crc) return ZT_ERR_CHECKSUM;
  if ((uint32_t)n != want_isize) return ZT_ERR_SIZE;
  if (consumed) *consumed = tpos + 8;
  return n;
}

int64_t gzip_compress_impl(const uint8_t* src, size_t src_len, int level,
                           uint8_t* dst, size_t dst_cap, int name_pad) {
  size_t hdr = 10 + (name_pad >= 0 ? (size_t)name_pad + 1 : 0);
  if (hdr + 18 > dst_cap) return ZT_ERR_DST_FULL;
  memset(dst, 0, 10);
  dst[0] = 0x1F;
  dst[1] = 0x8B;
  dst[2] = 8;
  dst[3] = name_pad >= 0 ? 8 : 0;  // FNAME
  size_t p = 10;
  if (name_pad >= 0) {
    for (int i = 0; i < name_pad; i++) dst[p++] = (uint8_t)('a' + i);
    dst[p++] = 0;
  }
  int64_t body = deflate_mt(src, src_len, level, dst + p, dst_cap - p - 8);
  if (body < 0) return body;
  p += (size_t)body;
  uint32_t crc = crc32(src, src_len);
  uint32_t isize = (uint32_t)src_len;
  memcpy(dst + p, &crc, 4);
  memcpy(dst + p + 4, &isize, 4);
  return (int64_t)(p + 8);
}

int64_t zlib_uncompress_impl(const uint8_t* src, size_t src_len, uint8_t* dst,
                             size_t dst_cap) {
  if (src_len < 6) return ZT_ERR_MALFORMED;
  uint8_t cmf = src[0], flg = src[1];
  if ((cmf & 0x0F) != 8) return ZT_ERR_MALFORMED;
  if ((cmf >> 4) > 7) return ZT_ERR_MALFORMED;
  if (((uint32_t)cmf * 256 + flg) % 31 != 0) return ZT_ERR_MALFORMED;
  if (flg & 0x20) return ZT_ERR_MALFORMED;  // FDICT unsupported
  size_t end_bit = 0;
  int64_t n = inflate_impl(src, src_len, 16, dst, dst_cap, &end_bit);
  if (n < 0) return n;
  size_t tpos = (end_bit + 7) / 8;
  if (tpos + 4 > src_len) return ZT_ERR_MALFORMED;
  uint32_t want = ((uint32_t)src[tpos] << 24) | ((uint32_t)src[tpos + 1] << 16)
                  | ((uint32_t)src[tpos + 2] << 8) | src[tpos + 3];
  if (adler32(dst, (size_t)n) != want) return ZT_ERR_CHECKSUM;
  return n;
}

int64_t zlib_compress_impl(const uint8_t* src, size_t src_len, int level,
                           uint8_t* dst, size_t dst_cap) {
  if (dst_cap < 8) return ZT_ERR_DST_FULL;
  dst[0] = 0x78;  // CM=8, CINFO=7
  uint8_t flg = 0;
  while (((uint32_t)dst[0] * 256 + flg) % 31 != 0) flg++;
  dst[1] = flg;
  int64_t body = deflate_mt(src, src_len, level, dst + 2, dst_cap - 6);
  if (body < 0) return body;
  size_t p = 2 + (size_t)body;
  uint32_t a = adler32(src, src_len);
  dst[p] = (uint8_t)(a >> 24);
  dst[p + 1] = (uint8_t)(a >> 16);
  dst[p + 2] = (uint8_t)(a >> 8);
  dst[p + 3] = (uint8_t)a;
  return (int64_t)(p + 4);
}

// ---------------------------------------------------------------------------
// The host scan of the device decode: one serial pass over a raw DEFLATE
// stream that records where the device can start decoding in parallel.
//
// DEFLATE decode is bit-serial: a symbol's length is unknown until it is
// decoded, so the device needs token boundaries found ahead of time. The
// scan walks the stream without keeping the output and records a
// checkpoint every `every` tokens. Outputs:
//   segments [nseg][6] int64 = {bit_offset, out_offset, block_id, ntok,
//                               match_bytes, max copy-nesting depth}
//   stored   [nsto][3] int64 = {src_byte_offset, out_offset, length}
//   block_lens [nblk][318] uint8 = litlen code lengths (288) + dist (30)
//   counts[7] = {nseg, nsto, nblk, total_out, end_bit, max_depth, adler32}
// Returns 0, -1 for a malformed stream, or -2 when a capacity was too
// small (counts then hold the exact sizes, so the caller retries sized).
// adler32 is that of the whole decoded output: the device decode checks its
// own output against it.
// ---------------------------------------------------------------------------

int64_t inflate_scan_impl(const uint8_t* src, size_t src_len, size_t start_bit,
                          uint32_t every, int64_t* seg, size_t seg_cap,
                          int64_t* sto, size_t sto_cap, uint8_t* block_lens,
                          size_t blk_cap, int64_t* counts) {
  if (every == 0) return ZT_ERR_MALFORMED;
  BitReader br(src, src_len, start_bit);
  size_t op = 0;
  size_t nseg = 0, nsto = 0, nblk = 0;
  bool final_block = false;
  HuffDecoder dyn_litlen, dyn_dist;
  // Exact per-byte copy-nesting depth over a rolling 32 KiB window (sources
  // never reach further back). The device resolver collapses a match's
  // overlap in closed form, so a match's effective source range is
  // [op - dist, op - dist + min(dist, len)) and its bytes' depth is 1 + the
  // source byte's depth; each tile runs ceil(log2(depth)) pointer-doubling
  // hops.
  std::vector<uint16_t> depth_win(kWindow, 0);
  int32_t max_depth = 0;
  // Rolling 32 KiB window of the decoded bytes, folded into an adler32 of
  // the whole output as they are produced: the device decode's integrity
  // gate.
  std::vector<uint8_t> byte_win(kWindow, 0);
  uint32_t ad_s1 = 1, ad_s2 = 0;
  size_t ad_n = 0;
  auto ad_byte = [&](uint8_t v) {
    ad_s1 += v;
    ad_s2 += ad_s1;
    if (++ad_n == 5552) {
      ad_s1 %= 65521;
      ad_s2 %= 65521;
      ad_n = 0;
    }
  };
  auto ad_flush = [&]() -> uint32_t {
    ad_s1 %= 65521;
    ad_s2 %= 65521;
    ad_n = 0;
    return (ad_s2 << 16) | ad_s1;
  };

  while (!final_block) {
    if (br.overrun()) return ZT_ERR_MALFORMED;
    final_block = br.bits(1) != 0;
    uint32_t btype = br.bits(2);

    if (btype == 0) {
      br.align_byte();
      uint32_t len = br.bits(16);
      uint32_t nlen = br.bits(16);
      if ((len ^ nlen) != 0xFFFF) return ZT_ERR_MALFORMED;
      size_t cur = br.byte_pos - (size_t)(br.cnt >> 3);
      if (cur + len > src_len) return ZT_ERR_MALFORMED;
      if (nsto < sto_cap) {
        sto[nsto * 3 + 0] = (int64_t)cur;
        sto[nsto * 3 + 1] = (int64_t)op;
        sto[nsto * 3 + 2] = (int64_t)len;
      }
      nsto++;
      {
        uint32_t a = ad_flush();
        a = adler32(src + cur, len, a);
        ad_s1 = a & 0xFFFF;
        ad_s2 = a >> 16;
        // Only the last window of a long stored span stays reachable.
        size_t from = len >= (size_t)kWindow ? len - kWindow : 0;
        for (size_t i = from; i < len; i++) {
          byte_win[(op + i) & (kWindow - 1)] = src[cur + i];
          depth_win[(op + i) & (kWindow - 1)] = 0;  // stored bytes: depth 0
        }
      }
      op += len;
      br.byte_pos = cur + len;
      br.buf = 0;
      br.cnt = 0;
      continue;
    }
    if (btype == 3) return ZT_ERR_MALFORMED;

    const HuffDecoder* litlen = &kFixed.litlen;
    const HuffDecoder* dist = &kFixed.dist;
    uint8_t lens[288 + 30] = {0};
    if (btype == 1) {
      for (int i = 0; i < 144; i++) lens[i] = 8;
      for (int i = 144; i < 256; i++) lens[i] = 9;
      for (int i = 256; i < 280; i++) lens[i] = 7;
      for (int i = 280; i < 288; i++) lens[i] = 8;
      for (int i = 0; i < 30; i++) lens[288 + i] = 5;
    } else {  // dynamic header
      uint32_t hlit = br.bits(5) + 257;
      uint32_t hdist = br.bits(5) + 1;
      uint32_t hclen = br.bits(4) + 4;
      if (hlit > 286 || hdist > 30) return ZT_ERR_MALFORMED;
      uint8_t cl_lens[19] = {0};
      for (uint32_t i = 0; i < hclen; i++)
        cl_lens[kClclOrder[i]] = (uint8_t)br.bits(3);
      HuffDecoder cl;
      if (!cl.build(cl_lens, 19)) return ZT_ERR_MALFORMED;
      uint8_t dlens[286 + 30] = {0};
      uint32_t total = hlit + hdist;
      uint32_t i = 0;
      while (i < total) {
        if (br.overrun()) return ZT_ERR_MALFORMED;
        int sym = cl.decode(br);
        if (sym < 0) return ZT_ERR_MALFORMED;
        if (sym < 16) {
          dlens[i++] = (uint8_t)sym;
        } else if (sym == 16) {
          if (i == 0) return ZT_ERR_MALFORMED;
          uint32_t rep = 3 + br.bits(2);
          if (i + rep > total) return ZT_ERR_MALFORMED;
          uint8_t v = dlens[i - 1];
          while (rep--) dlens[i++] = v;
        } else if (sym == 17) {
          uint32_t rep = 3 + br.bits(3);
          if (i + rep > total) return ZT_ERR_MALFORMED;
          i += rep;
        } else {
          uint32_t rep = 11 + br.bits(7);
          if (i + rep > total) return ZT_ERR_MALFORMED;
          i += rep;
        }
      }
      if (dlens[256] == 0) return ZT_ERR_MALFORMED;
      if (!dyn_litlen.build(dlens, (int)hlit)) return ZT_ERR_MALFORMED;
      if (!dyn_dist.build(dlens + hlit, (int)hdist)) return ZT_ERR_MALFORMED;
      litlen = &dyn_litlen;
      dist = &dyn_dist;
      memcpy(lens, dlens, hlit);
      memcpy(lens + 288, dlens + hlit, hdist);
    }
    size_t block_id = nblk;
    if (nblk < blk_cap) memcpy(block_lens + nblk * 318, lens, 318);
    nblk++;

    uint32_t tok_in_seg = every;  // a checkpoint at the block's first token
    for (;;) {
      if (br.overrun()) return ZT_ERR_MALFORMED;
      size_t tok_bit = br.consumed();
      int sym = litlen->decode(br);
      if (sym < 0 || sym > 285) return ZT_ERR_MALFORMED;
      if (sym == 256) break;
      if (tok_in_seg == every) {
        if (nseg < seg_cap) {
          seg[nseg * 6 + 0] = (int64_t)tok_bit;
          seg[nseg * 6 + 1] = (int64_t)op;
          seg[nseg * 6 + 2] = (int64_t)block_id;
          seg[nseg * 6 + 3] = 0;
          seg[nseg * 6 + 4] = 0;  // match output bytes (compaction capacity)
          seg[nseg * 6 + 5] = 0;  // max copy-nesting depth in the segment
        }
        nseg++;
        tok_in_seg = 0;
      }
      if (nseg - 1 < seg_cap) seg[(nseg - 1) * 6 + 3]++;
      tok_in_seg++;
      if (sym < 256) {
        depth_win[op & (kWindow - 1)] = 0;  // literal: depth 0
        byte_win[op & (kWindow - 1)] = (uint8_t)sym;
        ad_byte((uint8_t)sym);
        op++;
        continue;
      }
      uint32_t li = (uint32_t)sym - 257;
      uint32_t length = kBaseLengths[li] + br.bits(kLengthExtra[li]);
      int dsym = dist->decode(br);
      if (dsym < 0 || dsym > 29) return ZT_ERR_MALFORMED;
      uint32_t distance = kBaseDists[dsym] + br.bits(kDistExtra[dsym]);
      if (distance > op) return ZT_ERR_MALFORMED;
      {
        // Byte o of the span hops once to source byte s_lo + (o mod n_src),
        // so its depth is that byte's depth + 1. The segment's depth and
        // the adler sums are updated once per match, not per byte.
        size_t s_lo = op - distance;
        size_t n_src = std::min<size_t>(distance, length);
        size_t x = 0;
        uint32_t deepest = 0;
        // Reduce first if the match would reach 5552 unreduced bytes: the
        // sums stay below 2^32, and the literal path, which reduces at
        // exactly 5552, still meets its count.
        if (ad_n + length >= 5552) {
          ad_s1 %= 65521;
          ad_s2 %= 65521;
          ad_n = 0;
        }
        ad_n += length;
        for (size_t o = op; o < op + length; o++) {
          uint32_t d = depth_win[(s_lo + x) & (kWindow - 1)] + 1u;
          if (++x == n_src) x = 0;
          uint16_t d16 = (uint16_t)std::min<uint32_t>(d, 0xFFFF);
          depth_win[o & (kWindow - 1)] = d16;
          deepest = std::max<uint32_t>(deepest, d16);
          // Sequential copy semantics (read before write handles dist ==
          // kWindow: the source slot still holds its byte).
          uint8_t v = byte_win[(o - distance) & (kWindow - 1)];
          byte_win[o & (kWindow - 1)] = v;
          ad_s1 += v;
          ad_s2 += ad_s1;
        }
        if ((int32_t)deepest > max_depth) max_depth = (int32_t)deepest;
        if (nseg - 1 < seg_cap) {
          int64_t* rec = seg + (nseg - 1) * 6;
          rec[4] += (int64_t)length;
          if ((int64_t)deepest > rec[5]) rec[5] = (int64_t)deepest;
        }
      }
      op += length;
    }
  }
  if (br.overrun()) return ZT_ERR_MALFORMED;
  counts[0] = (int64_t)nseg;
  counts[1] = (int64_t)nsto;
  counts[2] = (int64_t)nblk;
  counts[3] = (int64_t)op;
  counts[4] = (int64_t)br.consumed();
  counts[5] = (int64_t)max_depth;
  counts[6] = (int64_t)ad_flush();
  if (nseg > seg_cap || nsto > sto_cap || nblk > blk_cap)
    return ZT_ERR_DST_FULL;
  return ZT_OK;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// One-time decode-index scan for device-parallel inflate (see
// inflate_scan_impl above). Returns 0, -1 malformed, or -2 caps exceeded
// (counts[] filled either way when non-negative progress was made).
int64_t zt_inflate_scan(const uint8_t* src, size_t src_len, size_t start_bit,
                        uint32_t every, int64_t* seg, size_t seg_cap,
                        int64_t* sto, size_t sto_cap, uint8_t* block_lens,
                        size_t blk_cap, int64_t* counts) {
  return inflate_scan_impl(src, src_len, start_bit, every, seg, seg_cap, sto,
                           sto_cap, block_lens, blk_cap, counts);
}

uint32_t zt_crc32(const uint8_t* data, size_t len) { return crc32(data, len); }

uint32_t zt_crc32_update(uint32_t crc, const uint8_t* data, size_t len) {
  return crc32(data, len, crc);
}

uint32_t zt_adler32(const uint8_t* data, size_t len) {
  return adler32(data, len);
}

uint32_t zt_adler32_update(uint32_t adler, const uint8_t* data, size_t len) {
  return adler32(data, len, adler);
}

// Inflate a raw deflate stream beginning at `start_bit` (bit offset into src).
// Returns bytes written (>=0), -1 malformed, -2 output buffer too small.
// *end_bit receives the bit offset just past the final block.
int64_t zt_inflate(const uint8_t* src, size_t src_len, size_t start_bit,
                   uint8_t* dst, size_t dst_cap, size_t* end_bit) {
  return inflate_impl(src, src_len, start_bit, dst, dst_cap, end_bit);
}

// Compress src as a raw deflate stream (multi-threaded above 512 KiB).
// Returns bytes written or -2 if dst is too small (use zt_deflate_bound).
int64_t zt_deflate(const uint8_t* src, size_t src_len, int level, uint8_t* dst,
                   size_t dst_cap) {
  return deflate_mt(src, src_len, level, dst, dst_cap);
}

size_t zt_deflate_bound(size_t src_len) { return deflate_bound(src_len); }

// Whole gzip member decode: header parse + inflate + crc32/ISIZE check.
// Returns payload length, or -1 malformed / -2 dst full / -3 bad checksum /
// -4 bad ISIZE. *consumed = bytes of src consumed (for multi-member).
int64_t zt_gzip_uncompress(const uint8_t* src, size_t src_len, uint8_t* dst,
                           size_t dst_cap, size_t* consumed) {
  return gzip_uncompress_impl(src, src_len, dst, dst_cap, consumed);
}

// Whole gzip member encode. name_pad >= 0 emits an FNAME of that many
// filler characters (the anti-oracle padding, reference zippy.nim:28-42);
// -1 omits FNAME.
int64_t zt_gzip_compress(const uint8_t* src, size_t src_len, int level,
                         uint8_t* dst, size_t dst_cap, int name_pad) {
  return gzip_compress_impl(src, src_len, level, dst, dst_cap, name_pad);
}

int64_t zt_zlib_uncompress(const uint8_t* src, size_t src_len, uint8_t* dst,
                           size_t dst_cap) {
  return zlib_uncompress_impl(src, src_len, dst, dst_cap);
}

int64_t zt_zlib_compress(const uint8_t* src, size_t src_len, int level,
                         uint8_t* dst, size_t dst_cap) {
  return zlib_compress_impl(src, src_len, level, dst, dst_cap);
}

}  // extern "C"

// The host scan of the device decode: one serial pass over a raw DEFLATE
// stream that records where the device can start decoding in parallel.
//
// A copy of what the scan needs from zippy_tpu/native/src/zippy_native.cpp
// (adler32, the RFC 1951 tables, BitReader, HuffDecoder, FixedTables and
// inflate_scan_impl), so that zippy_tpu_torch imports nothing of the JAX
// package. Built by zippy_tpu_torch/ops/inflate_scan.py with the host
// compiler (c++ -O2 -shared -fPIC) into build/kernels/ at first use and
// bound through ctypes (zt_inflate_scan at the bottom).
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

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

uint32_t adler32(const uint8_t* p, size_t n, uint32_t adler) {
  const uint32_t MOD = 65521;
  uint32_t s1 = adler & 0xFFFF, s2 = adler >> 16;
  // NMAX = largest n with 255n(n+1)/2 + (n+1)(MOD-1) < 2^32 (zlib's bound).
  const size_t NMAX = 5552;
  while (n) {
    size_t k = n < NMAX ? n : NMAX;
    n -= k;
    while (k--) {
      s1 += *p++;
      s2 += s1;
    }
    s1 %= MOD;
    s2 %= MOD;
  }
  return (s2 << 16) | s1;
}

// RFC 1951 constant tables.
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
const int kWindow = 32768;

// Bit reader: LSB-first, 64-bit buffer; past the end it loads zero bytes.
struct BitReader {
  const uint8_t* src;
  size_t len;
  size_t byte_pos;  // next byte to load
  uint64_t buf = 0;
  int cnt = 0;      // bits in buf

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
  inline void drop(int n) {
    buf >>= n;
    cnt -= n;
  }
  inline uint32_t bits(int n) {
    uint32_t v = peek(n);
    drop(n);
    return v;
  }
  // Bits consumed so far, counting the zero bytes loaded past the end.
  inline size_t consumed() const { return byte_pos * 8 - (size_t)cnt; }
  inline bool overrun() const { return consumed() > len * 8; }
  inline void align_byte() { drop(cnt & 7); }
};

// Canonical Huffman decode: a 10-bit table for short codes, then the
// canonical bit-by-bit walk.
const int kLutBits = 10;

struct HuffDecoder {
  uint16_t lut[1 << kLutBits];  // (sym << 4) | code_len; 0 = slow path
  uint16_t first_code[16];      // canonical MSB-first first code per length
  uint16_t limit[16];           // first_code + count
  uint16_t offset[16];          // index of the first symbol of this length
  uint16_t sorted_syms[288];
  int num_codes = 0;

  // False on an over-subscribed code. An incomplete code is accepted here;
  // reaching one of its unassigned codes fails the decode.
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
        // Reverse the l-bit code: the stream is LSB-first, codes MSB-first.
        uint32_t r = 0;
        for (int b = 0; b < l; b++) r |= ((c >> b) & 1) << (l - 1 - b);
        for (uint32_t i = r; i < (1u << kLutBits); i += 1u << l)
          lut[i] = (uint16_t)((sym << 4) | l);
      }
    }
    return true;
  }

  // The symbol, or -1 on an unassigned code.
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
    dist.build(dd, 30);
  }
};
const FixedTables kFixed;

enum {
  ZT_OK = 0,
  ZT_ERR_MALFORMED = -1,
  ZT_ERR_DST_FULL = -2,
};

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

extern "C" {

int64_t zt_inflate_scan(const uint8_t* src, size_t src_len, size_t start_bit,
                        uint32_t every, int64_t* seg, size_t seg_cap,
                        int64_t* sto, size_t sto_cap, uint8_t* block_lens,
                        size_t blk_cap, int64_t* counts) {
  return inflate_scan_impl(src, src_len, start_bit, every, seg, seg_cap, sto,
                           sto_cap, block_lens, blk_cap, counts);
}

}  // extern "C"

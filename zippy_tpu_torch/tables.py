"""RFC 1951 (DEFLATE) constant tables, laid out as numpy arrays for device use.

These values come from the DEFLATE specification (RFC 1951 §3.2.5-3.2.7).
A copy of zippy_tpu.tables, so the port imports nothing of the JAX package.
Parity reference: zippy's src/zippy/internal.nim:26-189 holds the same
constants; ours are derived from the RFC directly and stored SoA so they can be
used as gather tables by the device encoder.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Stream structure limits (RFC 1951; reference internal.nim:14-16)
# ---------------------------------------------------------------------------
MAX_WINDOW_SIZE = 32 * 1024          # LZ77 history window
MAX_MATCH_LEN = 258
MIN_MATCH_LEN = 3
MAX_STORED_BLOCK_SIZE = 0xFFFF       # 65535: LEN field is 16-bit
MAX_BLOCK_SIZE = 4 * 1024 * 1024     # encoder block-split seam (4 MiB)

MAX_LITLEN_CODES = 286               # 0..255 literals, 256 EOB, 257..285 lengths
MAX_DISTANCE_CODES = 30
MAX_CODE_LENGTH = 15                 # Huffman code length cap (litlen/dist)
MAX_CLCL_LENGTH = 7                  # cap for the code-length alphabet's codes

FIRST_LENGTH_CODE_INDEX = 257

# ---------------------------------------------------------------------------
# Length codes 257..285 (RFC 1951 §3.2.5)
# ---------------------------------------------------------------------------
BASE_LENGTHS = np.array([
    3, 4, 5, 6, 7, 8, 9, 10,          # 257..264, 0 extra bits
    11, 13, 15, 17,                    # 265..268, 1 extra bit
    19, 23, 27, 31,                    # 269..272, 2
    35, 43, 51, 59,                    # 273..276, 3
    67, 83, 99, 115,                   # 277..280, 4
    131, 163, 195, 227,                # 281..284, 5
    258,                               # 285, 0 extra bits
], dtype=np.int32)

LENGTH_EXTRA_BITS = np.array(
    [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0],
    dtype=np.int32,
)

assert len(BASE_LENGTHS) == 29 and len(LENGTH_EXTRA_BITS) == 29


def _build_length_to_code() -> np.ndarray:
    """lut[length-3] -> length code index 0..28 (code = 257 + index)."""
    lut = np.zeros(MAX_MATCH_LEN - MIN_MATCH_LEN + 1, dtype=np.int32)
    for idx in range(29):
        base = int(BASE_LENGTHS[idx])
        span = 1 << int(LENGTH_EXTRA_BITS[idx])
        for length in range(base, min(base + span, MAX_MATCH_LEN + 1)):
            lut[length - MIN_MATCH_LEN] = idx
    lut[MAX_MATCH_LEN - MIN_MATCH_LEN] = 28  # length 258 uses code 285
    return lut


LENGTH_TO_CODE_INDEX = _build_length_to_code()  # shape (256,)

# ---------------------------------------------------------------------------
# Distance codes 0..29 (RFC 1951 §3.2.5)
# ---------------------------------------------------------------------------
BASE_DISTANCES = np.array([
    1, 2, 3, 4,                        # 0..3, 0 extra
    5, 7,                              # 4..5, 1
    9, 13,                             # 6..7, 2
    17, 25,                            # 3
    33, 49,                            # 4
    65, 97,                            # 5
    129, 193,                          # 6
    257, 385,                          # 7
    513, 769,                          # 8
    1025, 1537,                        # 9
    2049, 3073,                        # 10
    4097, 6145,                        # 11
    8193, 12289,                       # 12
    16385, 24577,                      # 13
], dtype=np.int32)

DISTANCE_EXTRA_BITS = np.array(
    [0, 0, 0, 0] + [b for b in range(1, 14) for _ in (0, 1)],
    dtype=np.int32,
)

assert len(BASE_DISTANCES) == 30 and len(DISTANCE_EXTRA_BITS) == 30


def _build_distance_to_code() -> np.ndarray:
    """Two-level LUT mirrored from the classic zlib d_code trick.

    dist_code(d) = lut_lo[d-1] if d <= 256 else lut_hi[(d-1) >> 7]
    """
    lut_lo = np.zeros(256, dtype=np.int32)
    lut_hi = np.zeros(256, dtype=np.int32)
    for idx in range(30):
        base = int(BASE_DISTANCES[idx])
        end = base + (1 << int(DISTANCE_EXTRA_BITS[idx]))  # exclusive
        for dist in range(base, min(end, 257)):
            lut_lo[dist - 1] = idx
        for slot in range((max(base, 257) - 1) >> 7, (min(end, 32769) - 1 + 127) >> 7):
            if slot >= 2:  # slots 2..255 cover distances 257..32768
                lut_hi[slot] = idx
    return np.concatenate([lut_lo, lut_hi])


DISTANCE_CODE_LUT = _build_distance_to_code()  # shape (512,)


def distance_code_index(distance: np.ndarray) -> np.ndarray:
    """Vectorized distance -> distance code index (numpy version)."""
    d1 = distance - 1
    return np.where(
        distance <= 256,
        DISTANCE_CODE_LUT[np.minimum(d1, 255)],
        DISTANCE_CODE_LUT[256 + (d1 >> 7)],
    )


# ---------------------------------------------------------------------------
# Code-length (CL) alphabet order for the dynamic block header (RFC 1951 §3.2.7)
# ---------------------------------------------------------------------------
CLCL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Fixed Huffman code lengths (RFC 1951 §3.2.6)
# ---------------------------------------------------------------------------
FIXED_LITLEN_LENGTHS = np.array(
    [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, dtype=np.int32
)  # 288 entries; 286/287 never occur in valid streams
FIXED_DISTANCE_LENGTHS = np.full(30, 5, dtype=np.int32)


def reverse_bits(code: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Bit-reverse `code` within `nbits` bits (DEFLATE emits codes MSB-first
    into an LSB-first stream, so canonical codes are stored pre-reversed)."""
    code = np.asarray(code, dtype=np.uint32)
    v = code
    r = np.zeros_like(v)
    for _ in range(16):
        r = (r << np.uint32(1)) | (v & np.uint32(1))
        v = v >> np.uint32(1)
    return (r >> (np.uint32(16) - nbits.astype(np.uint32))).astype(np.uint32)


def canonical_codes(code_lengths: np.ndarray) -> np.ndarray:
    """Canonical Huffman codes (bit-reversed, ready for LSB-first emission).

    RFC 1951 §3.2.2 algorithm: codes assigned in symbol order within each
    length, lengths ascending.
    """
    code_lengths = np.asarray(code_lengths, dtype=np.int32)
    max_len = int(code_lengths.max()) if code_lengths.size else 0
    bl_count = np.bincount(code_lengths, minlength=max_len + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 2, dtype=np.uint32)
    code = 0
    for bits in range(1, max_len + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    codes = np.zeros(code_lengths.shape, dtype=np.uint32)
    for sym in range(len(code_lengths)):
        ln = int(code_lengths[sym])
        if ln != 0:
            codes[sym] = next_code[ln]
            next_code[ln] += 1
    return reverse_bits(codes, code_lengths)


FIXED_LITLEN_CODES = canonical_codes(FIXED_LITLEN_LENGTHS)
FIXED_DISTANCE_CODES = canonical_codes(FIXED_DISTANCE_LENGTHS)

# ---------------------------------------------------------------------------
# Encoder work-factor table, one row per level 1..9 (zlib-style; reference
# internal.nim:177-189). Columns: good, lazy, nice, chain.
#   good  — match length at which we reduce search effort
#   lazy  — reserved for lazy evaluation (reference is greedy; so are we)
#   nice  — match length considered "good enough" to stop searching
#   chain — max candidate positions examined per position
# ---------------------------------------------------------------------------
LEVEL_CONFIG = {
    1: (4, 4, 8, 4),
    2: (4, 5, 16, 8),
    3: (4, 6, 32, 32),
    4: (4, 4, 16, 16),
    5: (8, 16, 32, 32),
    6: (8, 16, 128, 128),
    7: (8, 32, 128, 256),
    8: (32, 128, 258, 1024),
    9: (32, 258, 258, 4096),
}
DEFAULT_LEVEL_ROW = 6  # level -1 maps to level 6's row (reference deflate.nim:267)

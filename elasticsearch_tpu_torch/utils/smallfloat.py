"""Lucene-compatible SmallFloat norm encoding.

A copy of elasticsearch_tpu/utils/smallfloat.py, whole (the port imports
nothing of the JAX package).

Elasticsearch/Lucene store the per-document field length ("norm") as a single
byte using a 4-significant-bit float-like encoding, and BM25 scores are
computed against the *quantized* length decoded from that byte. Bit-for-bit
parity with this quantization is required for identical top-k hits
(reference: norm writing in Lucene's SmallFloat, consumed by the BM25
similarity configured at server/src/main/java/org/elasticsearch/index/
similarity/SimilarityService.java:43-59).

Values 0..23 are exact; larger lengths keep 4 significant bits. The encoding
is order-preserving.
"""

from __future__ import annotations

import numpy as np


def long_to_int4(i: int) -> int:
    """Order-preserving 4-significant-bit encoding of a non-negative int."""
    if i < 0:
        raise ValueError(f"only supports positive values, got {i}")
    num_bits = i.bit_length()
    if num_bits < 4:
        return i
    shift = num_bits - 4
    encoded = (i >> shift) & 0x07  # implicit leading bit dropped
    encoded |= (shift + 1) << 3
    return encoded


def int4_to_long(i: int) -> int:
    bits = i & 0x07
    shift = (i >> 3) - 1
    if shift == -1:
        return bits  # subnormal
    return (bits | 0x08) << shift


_MAX_INT4 = long_to_int4(2**31 - 1)
NUM_FREE_VALUES = 255 - _MAX_INT4  # == 24 for the int range Lucene supports


def int_to_byte4(i: int) -> int:
    """Encode a field length as an unsigned norm byte (0..255)."""
    if i < 0:
        raise ValueError(f"only supports positive values, got {i}")
    if i < NUM_FREE_VALUES:
        return i
    return NUM_FREE_VALUES + long_to_int4(i - NUM_FREE_VALUES)


def byte4_to_int(b: int) -> int:
    """Decode an unsigned norm byte back to the quantized field length."""
    if b < NUM_FREE_VALUES:
        return b
    return NUM_FREE_VALUES + int4_to_long(b - NUM_FREE_VALUES)


# 256-entry decode tables. LENGTH_TABLE is float32 — the same fp32 rounding
# Lucene's BM25 applies when it precomputes per-norm cache entries — and is
# what scoring must use for parity. LENGTH_TABLE_INT is exact and is what
# encoding must use (fp32 rounding of values near 2^31 would misencode).
LENGTH_TABLE_INT: np.ndarray = np.array(
    [byte4_to_int(b) for b in range(256)], dtype=np.int64
)
LENGTH_TABLE: np.ndarray = LENGTH_TABLE_INT.astype(np.float32)


def encode_lengths(lengths: np.ndarray) -> np.ndarray:
    """Vectorized int_to_byte4 over an array of field lengths -> uint8.

    int_to_byte4 truncates (rounds toward zero) and LENGTH_TABLE is strictly
    increasing, so the encoded byte is the largest b with decode(b) <= length.
    """
    lengths = np.asarray(lengths)
    idx = np.searchsorted(LENGTH_TABLE_INT, lengths.astype(np.int64), side="right") - 1
    return np.clip(idx, 0, 255).astype(np.uint8)


def quantize_lengths(lengths: np.ndarray) -> np.ndarray:
    """Round-trip lengths through the norm byte -> float32 quantized lengths."""
    return LENGTH_TABLE[encode_lengths(lengths)]

"""2-bit packed DNA arrays — the array-native DnaBitset equivalent.

The reference packs each read into a per-read heap object
(reference: src/dnaToBits.cpp, include/dnaToBits.h). Here reads live in flat
numpy arrays so whole batches move to the device as one buffer:

- code space: A=0, C=1, G=2, T=3 (``BASE_CODES``); non-ACGT bases are mapped
  to A at pack time and recorded separately as (position, byte) exceptions so
  round-trips stay lossless for arbitrary FASTQ (the reference's
  ``baseToInt`` bit-trick silently aliases 'N' onto the 2-bit alphabet —
  src/dnaToBits.cpp:6-9 — we do strictly better).
- packed layout: 4 bases per uint8, base i in bits ``2*(i % 4)`` of byte
  ``i // 4``. This layout unpacks with shifts/masks only, identical on host
  numpy and on the device (ops/sketch.py unpacks it there).

Everything here is vectorized numpy; no Python per-base loops.
"""

from __future__ import annotations

import numpy as np

# ASCII -> 2-bit code lookup. Non-ACGT maps to 0 ('A'); callers that need
# losslessness must also collect exceptions via `find_exceptions`.
_ENC_LUT = np.zeros(256, dtype=np.uint8)
_ENC_LUT[ord("A")] = 0
_ENC_LUT[ord("C")] = 1
_ENC_LUT[ord("G")] = 2
_ENC_LUT[ord("T")] = 3
_ENC_LUT[ord("a")] = 0
_ENC_LUT[ord("c")] = 1
_ENC_LUT[ord("g")] = 2
_ENC_LUT[ord("t")] = 3

_IS_ACGT = np.zeros(256, dtype=bool)
for _b in b"ACGT":
    _IS_ACGT[_b] = True

_DEC_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)

# complement of code c is 3 - c (A<->T, C<->G)


def encode_ascii(seq_bytes: np.ndarray) -> np.ndarray:
    """uint8 ASCII array -> uint8 2-bit-code array (same length)."""
    return _ENC_LUT[seq_bytes]


def decode_to_ascii(codes: np.ndarray) -> np.ndarray:
    """uint8 code array -> uint8 ASCII array."""
    return _DEC_LUT[codes]


def find_exceptions(seq_bytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Positions and original bytes of non-ACGT characters (uppercase pass-through).

    Lowercase acgt is treated as an exception too (we re-emit the exact input
    byte on decompress), keeping the contract byte-identical rather than
    case-normalized.
    """
    bad = ~_IS_ACGT[seq_bytes]
    pos = np.flatnonzero(bad)
    return pos.astype(np.int64), seq_bytes[pos]


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """2-bit codes (uint8, len L) -> packed uint8 array of len ceil(L/4)."""
    L = codes.shape[0]
    pad = (-L) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    quads = codes.reshape(-1, 4).astype(np.uint16)
    packed = quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
    return packed.astype(np.uint8)


def unpack_codes(packed: np.ndarray, length: int) -> np.ndarray:
    """Packed uint8 array -> first `length` 2-bit codes (uint8)."""
    quads = np.empty((packed.shape[0], 4), dtype=np.uint8)
    quads[:, 0] = packed & 3
    quads[:, 1] = (packed >> 2) & 3
    quads[:, 2] = (packed >> 4) & 3
    quads[:, 3] = (packed >> 6) & 3
    return quads.reshape(-1)[:length]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space (c -> 3-c, reversed)."""
    return (3 - codes[::-1]).astype(np.uint8)


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return encode_ascii(np.frombuffer(seq, dtype=np.uint8))


def codes_to_seq(codes: np.ndarray) -> str:
    return decode_to_ascii(codes).tobytes().decode("ascii")

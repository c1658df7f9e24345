"""Host k-mer helpers: 2-bit base encoding and the sampling threshold.

Copy of the host-side part of ``kbbq_tpu/oracle/kmers.py`` (DECISIONS.md
D1, D5); the batched k-mer packing and hashing live in ``ops/kmers.py``.
"""

from __future__ import annotations

import numpy as np

from ..constants import BASE_N

_U32 = np.uint32
_ENCODE_LUT = np.full(256, BASE_N, dtype=np.int8)
for i, b in enumerate(b"ACGT"):
    _ENCODE_LUT[b] = i
for i, b in enumerate(b"acgt"):
    _ENCODE_LUT[b] = i
_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()


def encode_seq(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> int8 codes (A=0 C=1 G=2 T=3, other=4)."""
    if isinstance(seq, (bytes, bytearray, str)):
        if isinstance(seq, str):
            seq = seq.encode()
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    return _ENCODE_LUT[arr]


def decode_seq(codes: np.ndarray) -> bytes:
    return _DECODE_LUT[np.asarray(codes, dtype=np.int64)].tobytes()


def alpha_threshold(alpha: float) -> np.uint32:
    """Inclusive keep threshold: keep iff sample_hash <= alpha_threshold.

    t = floor(alpha * 2^32) - 1 clamped to [0, 2^32-1]; alpha >= 1 keeps
    everything (t = 2^32-1).  alpha must be > 0.
    """
    if alpha >= 1.0:
        return _U32(0xFFFFFFFF)
    t = int(alpha * 4294967296.0) - 1
    return _U32(max(0, min(t, 0xFFFFFFFF)))

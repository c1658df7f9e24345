"""Oracle k-mer layer: 2-bit encoding, canonical packing, 32-bit hashing.

Copy of ``kbbq_tpu/oracle/kmers.py`` (DECISIONS.md D1-D3, D5): the
executable spec that the batched torch versions in ``ops/kmers.py`` match
operation for operation.  Everything is expressed over (hi, lo) uint32 lane
pairs; NumPy's uint32 arithmetic wraps, as the spec requires.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    BASE_N,
    FMIX32_C1,
    FMIX32_C2,
    HASH_SEED_H1,
    HASH_SEED_H2,
    HASH_SEED_SAMPLE,
)

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


def fmix32(x: np.ndarray | int) -> np.ndarray:
    """murmur3 finalizer; operates in uint32 with wraparound (D3)."""
    x = np.asarray(x, dtype=_U32).copy()
    with np.errstate(over="ignore"):
        x ^= x >> _U32(16)
        x *= _U32(FMIX32_C1)
        x ^= x >> _U32(13)
        x *= _U32(FMIX32_C2)
        x ^= x >> _U32(16)
    return x


def _shift_left_2(hi: np.ndarray, lo: np.ndarray, mask_hi: int):
    """(hi,lo) <<= 2 within 2k bits; returns new (hi, lo) sans new base."""
    new_hi = ((hi << _U32(2)) | (lo >> _U32(30))) & _U32(mask_hi)
    new_lo = lo << _U32(2)
    return new_hi, new_lo


def canonical_kmers(codes: np.ndarray, k: int):
    """All k-mer windows of a single read, canonicalized.

    Args:
      codes: int8 [L] base codes (4 = N).
    Returns:
      (hi, lo, valid): uint32 [L-k+1] lane arrays of the canonical k-mer per
      window offset, and a bool validity mask (False where the window
      contains an N).  L < k yields empty arrays.

    Forward packing is big-endian (first base in the highest bits of the
    2k-bit word); reverse complement is built rolling from the right.  This
    loop formulation is the clarity-first oracle; ``ops/kmers.py``
    vectorizes the same recurrence over the batch.
    """
    codes = np.asarray(codes, dtype=np.int64)
    L = codes.shape[0]
    n = L - k + 1
    if n <= 0:
        z = np.zeros(0, dtype=_U32)
        return z, z.copy(), np.zeros(0, dtype=bool)

    if k >= 17:
        hi_bits = 2 * k - 32
        mask_hi = (1 << hi_bits) - 1
        mask_lo = 0xFFFFFFFF
    else:
        mask_hi = 0
        mask_lo = (1 << (2 * k)) - 1

    out_hi = np.zeros(n, dtype=_U32)
    out_lo = np.zeros(n, dtype=_U32)
    out_valid = np.zeros(n, dtype=bool)

    fh = fl = 0  # forward (hi, lo) python ints for clarity
    rh = rl = 0  # reverse-complement
    run = 0      # number of consecutive valid bases ending here
    for i in range(L):
        c = int(codes[i])
        if c == BASE_N:
            run = 0
            fh = fl = rh = rl = 0
            continue
        run += 1
        # forward: shift left 2, or in new base
        fh = ((fh << 2) | (fl >> 30)) & mask_hi
        fl = ((fl << 2) | c) & mask_lo
        # reverse complement: shift right 2, put complement at the top
        comp = 3 - c
        if k >= 17:
            rl = ((rl >> 2) | ((rh & 3) << 30)) & 0xFFFFFFFF
            rh = ((rh >> 2) | (comp << (2 * k - 32 - 2))) & mask_hi
        else:
            rl = ((rl >> 2) | (comp << (2 * k - 2))) & mask_lo
            rh = 0
        if run >= k:
            j = i - k + 1
            # canonical = min(forward, rc) by (hi, lo) unsigned compare
            if (fh, fl) <= (rh, rl):
                out_hi[j], out_lo[j] = fh, fl
            else:
                out_hi[j], out_lo[j] = rh, rl
            out_valid[j] = True
    return out_hi, out_lo, out_valid


def kmer_hashes(hi: np.ndarray, lo: np.ndarray):
    """(h1, h2): block selector / in-block offset source per D3."""
    hi = np.asarray(hi, dtype=_U32)
    lo = np.asarray(lo, dtype=_U32)
    h1 = fmix32(lo ^ fmix32(hi ^ _U32(HASH_SEED_H1)))
    h2 = fmix32(hi ^ fmix32(lo ^ _U32(HASH_SEED_H2)))
    return h1, h2


def probe_positions(h1: np.ndarray, h2: np.ndarray, num_hashes: int, log2_m: int):
    """BLOCKED probe slots (D3): block = h1 & (R-1) with R = 2^log2_m / 32;
    off_i = rotr32(h2, (5i) & 31) & 31; slot = block*32 + off_i.
    Returns uint32 [..., num_hashes] (int64 past 2^32 slots: slot values
    no longer fit 32 bits; block selection stays identical 32-bit math).
    All probes share one 32-byte line.  log2_m caps at MAX_BLOOM_LOG2
    (= 36): blocks must number < 2^31 for device int32 word indices.
    """
    h1 = np.asarray(h1, dtype=_U32)
    h2 = np.asarray(h2, dtype=_U32)
    block = h1 & _U32((1 << min(log2_m - 5, 32)) - 1)
    s = (np.arange(num_hashes, dtype=_U32) * _U32(5)) & _U32(31)
    with np.errstate(over="ignore"):
        rot = ((h2[..., None] >> s) |
               (h2[..., None] << ((_U32(32) - s) & _U32(31))))
    off = rot & _U32(31)
    if log2_m > 32:
        return (block[..., None].astype(np.int64) << 5) | off
    return (block[..., None] << _U32(5)) | off


def sample_hash(read_id: np.ndarray, offset: np.ndarray) -> np.ndarray:
    """Per-occurrence subsampling hash keyed on (global read id, window
    offset) — DECISIONS.md D5.  Per-occurrence (not per-value) sampling is
    what gives correct k-mers their 1-(1-a)^C amplification.
    """
    r = np.asarray(read_id, dtype=_U32)
    j = np.asarray(offset, dtype=_U32)
    with np.errstate(over="ignore"):
        return fmix32(fmix32(r ^ _U32(HASH_SEED_SAMPLE))
                      ^ (j * _U32(0x9E3779B9)))


def alpha_threshold(alpha: float) -> np.uint32:
    """Inclusive keep threshold: keep iff sample_hash <= alpha_threshold.

    t = floor(alpha * 2^32) - 1 clamped to [0, 2^32-1]; alpha >= 1 keeps
    everything (t = 2^32-1).  alpha must be > 0.
    """
    if alpha >= 1.0:
        return _U32(0xFFFFFFFF)
    t = int(alpha * 4294967296.0) - 1
    return _U32(max(0, min(t, 0xFFFFFFFF)))

"""Batched k-mer packing and 32-bit hashing on tensors.

Counterpart of ``kbbq_tpu/ops/kmers.py`` (DECISIONS.md D1-D3, D5), bit for
bit.  A k-mer is a (hi, lo) pair of 32-bit words: forward packing is
big-endian (first base in the highest bits of the 2k-bit word), hi holds
bits 32.., lo bits 0..31.

How 32-bit unsigned values travel in torch: as ``int32`` tensors carrying
the bit pattern (torch's uint32 has no shifts, compares or scatter on the
CPU).  Arithmetic is done "wide": in int64, every value masked to
[0, 2^32).  An int64 product of two such values may wrap, but its low 32
bits are right, and no negative value is ever shifted right.  Public
functions take either form (``u32_to_wide`` normalises both) and return
int32 patterns; the ``_w`` helpers stay wide for callers that chain them.

Packing is written for a device where a strided read is cheap: window j's
word is the OR of k shifted slices of the code matrix, no log-doubling and
no rolls.
"""

from __future__ import annotations

import torch

from ..constants import (
    FMIX32_C1,
    FMIX32_C2,
    HASH_SEED_H1,
    HASH_SEED_H2,
    HASH_SEED_SAMPLE,
)

M32 = 0xFFFFFFFF


def u32_to_wide(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or int64 value) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & M32


def wide_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 carrying the same 32 bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _fmix32_w(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * FMIX32_C1) & M32
    x = x ^ (x >> 13)
    x = (x * FMIX32_C2) & M32
    x = x ^ (x >> 16)
    return x


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on 32-bit words (oracle: kmers.fmix32)."""
    return wide_to_u32(_fmix32_w(u32_to_wide(x)))


def _kmer_lanes_w(codes: torch.Tensor, k: int):
    """kmer_lanes_batch in wide form: (fhi, flo, rhi, rlo int64, valid)."""
    B, L = codes.shape
    n = L - k + 1
    if n <= 0:
        z = torch.zeros((B, 0), dtype=torch.int64, device=codes.device)
        return z, z.clone(), z.clone(), z.clone(), \
            torch.zeros((B, 0), dtype=torch.bool, device=codes.device)
    isn = codes >= 4
    c = torch.where(isn, torch.zeros_like(codes), codes).to(torch.int64)
    comp = 3 - c
    fhi = torch.zeros((B, n), dtype=torch.int64, device=codes.device)
    flo = torch.zeros_like(fhi)
    rhi = torch.zeros_like(fhi)
    rlo = torch.zeros_like(fhi)
    for i in range(k):
        # base at window offset i: forward bit 2(k-1-i), RC bit 2i
        sf = 2 * (k - 1 - i)
        if sf >= 32:
            fhi |= c[:, i:i + n] << (sf - 32)
        else:
            flo |= c[:, i:i + n] << sf
        sr = 2 * i
        if sr >= 32:
            rhi |= comp[:, i:i + n] << (sr - 32)
        else:
            rlo |= comp[:, i:i + n] << sr
    cs = torch.nn.functional.pad(isn.to(torch.int32).cumsum(1), (1, 0))
    valid = (cs[:, k:] - cs[:, :n]) == 0
    return fhi, flo, rhi, rlo, valid


def kmer_lanes_batch(codes: torch.Tensor, k: int):
    """Raw forward/RC lane pairs for every window of every read.

    Args:
      codes: int8 [B, L] base codes (4 = N/pad).
      k: k-mer size (<= 32).
    Returns:
      (fhi, flo, rhi, rlo, valid): int32 patterns x4 + bool, each [B, n],
      n = L-k+1 (n <= 0 gives empty [B, 0] tensors).  Lane values of
      invalid windows are unspecified.
    """
    fhi, flo, rhi, rlo, valid = _kmer_lanes_w(codes, k)
    return (wide_to_u32(fhi), wide_to_u32(flo), wide_to_u32(rhi),
            wide_to_u32(rlo), valid)


def _canonical_w(fhi, flo, rhi, rlo):
    fwd_le = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    return torch.where(fwd_le, fhi, rhi), torch.where(fwd_le, flo, rlo)


def canonical_from_lanes(fhi, flo, rhi, rlo):
    """min(forward, rc) by (hi, lo) unsigned compare (oracle D2)."""
    hi, lo = _canonical_w(u32_to_wide(fhi), u32_to_wide(flo),
                          u32_to_wide(rhi), u32_to_wide(rlo))
    return wide_to_u32(hi), wide_to_u32(lo)


def _canonical_kmers_w(codes: torch.Tensor, k: int):
    fhi, flo, rhi, rlo, valid = _kmer_lanes_w(codes, k)
    hi, lo = _canonical_w(fhi, flo, rhi, rlo)
    return hi, lo, valid


def canonical_kmers_batch(codes: torch.Tensor, k: int):
    """Canonical k-mers for every window of every read.

    Returns (hi, lo, valid): int32 patterns / bool [B, n] with n = L-k+1.
    Matches oracle canonical_kmers exactly on valid windows.
    """
    hi, lo, valid = _canonical_kmers_w(codes, k)
    return wide_to_u32(hi), wide_to_u32(lo), valid


def _kmer_hashes_w(hi, lo):
    h1 = _fmix32_w(lo ^ _fmix32_w(hi ^ HASH_SEED_H1))
    h2 = _fmix32_w(hi ^ _fmix32_w(lo ^ HASH_SEED_H2))
    return h1, h2


def kmer_hashes(hi: torch.Tensor, lo: torch.Tensor):
    """(h1, h2): block selector / in-block offsets (oracle: kmer_hashes)."""
    h1, h2 = _kmer_hashes_w(u32_to_wide(hi), u32_to_wide(lo))
    return wide_to_u32(h1), wide_to_u32(h2)


def sample_keep_mask(read_ids: torch.Tensor, num_windows: int,
                     threshold: int) -> torch.Tensor:
    """Per-occurrence sampling decisions (oracle: sample_hash; D5).

    Args:
      read_ids: [B] global read ordinals (int64 values or int32 patterns).
      num_windows: window count n.
      threshold: inclusive keep threshold in [0, 2^32).
    Returns: bool [B, n].
    """
    r = u32_to_wide(read_ids)[:, None]
    j = torch.arange(num_windows, dtype=torch.int64,
                     device=read_ids.device)[None, :]
    s = _fmix32_w(_fmix32_w(r ^ HASH_SEED_SAMPLE)
                  ^ ((j * 0x9E3779B9) & M32))
    return s <= int(threshold)

"""Blocked Bloom filter ops on tensors (DECISIONS.md D3/D4).

Counterpart of ``kbbq_tpu/ops/bloom.py`` and ``ops/pallas_bloom.py``.  All
probes of a k-mer live in one 32-bit block word, so a query is ONE random
word fetch plus bit tests, and an insert is one OR of the k-mer's probe
word into its block word.

The packed filter is a contiguous ``torch.int32 [m/32]`` tensor holding the
uint32 bit pattern; word b's bit j is slot b*32 + j.

Two of the functions here are kernels on the card: the membership probe
(``bloom_query_rows`` / ``bloom_query_words``, kernel ``bloom_probe``) and
the build (``bloom_build_words``, kernel ``bloom_or_words``; its fused entry
point, which hashes the reads itself, is ``ops.hash_cache``).  Each has its
plain PyTorch version beside it (``*_plain``); the dispatching function
takes the plain version only for CPU tensors and launches the kernel for
CUDA tensors.
"""

from __future__ import annotations

import torch

from ..constants import MAX_BLOOM_LOG2
from .kmers import M32, _kmer_hashes_w, u32_to_wide, wide_to_u32


def _log2_m_of(packed: torch.Tensor) -> int:
    words = int(packed.shape[0])
    log2_m = (words * 32).bit_length() - 1
    if packed.dim() != 1 or (1 << log2_m) != words * 32:
        raise ValueError("packed filter must be 1-D with a power-of-two "
                         "number of words")
    return log2_m


def _block_of(h1: torch.Tensor, log2_m: int) -> torch.Tensor:
    """Word index of a k-mer's block: h1 & (2^(log2_m-5) - 1), int64."""
    if not 5 <= log2_m <= MAX_BLOOM_LOG2:
        raise ValueError(f"log2_m must be in 5..{MAX_BLOOM_LOG2}, "
                         f"got {log2_m}")
    return u32_to_wide(h1) & ((1 << (log2_m - 5)) - 1)


def _hash_offsets_w(h2: torch.Tensor, num_hashes: int) -> torch.Tensor:
    s = (torch.arange(num_hashes, dtype=torch.int64, device=h2.device)
         * 5) & 31
    h = h2[..., None]
    rot = ((h >> s) | (h << ((32 - s) & 31))) & M32
    return rot & 31


def hash_offsets(h2: torch.Tensor, num_hashes: int) -> torch.Tensor:
    """int64 [..., h] in-word bit offsets from the second hash (D3)."""
    return _hash_offsets_w(u32_to_wide(h2), num_hashes)


def block_and_offsets_h(h1: torch.Tensor, h2: torch.Tensor,
                        num_hashes: int, log2_m: int):
    """(block [...], off [..., h]) int64 from precomputed (h1, h2)."""
    return _block_of(h1, log2_m), hash_offsets(h2, num_hashes)


def block_and_offsets(hi: torch.Tensor, lo: torch.Tensor, num_hashes: int,
                      log2_m: int):
    """(block [...], off [..., h]) for row-wise queries."""
    h1, h2 = _kmer_hashes_w(u32_to_wide(hi), u32_to_wide(lo))
    return block_and_offsets_h(h1, h2, num_hashes, log2_m)


def _probe_word_w(h2: torch.Tensor, num_hashes: int) -> torch.Tensor:
    w = torch.zeros_like(h2)
    for j in range(num_hashes):
        s = (j * 5) & 31
        rot = ((h2 >> s) | (h2 << ((32 - s) & 31))) & M32
        w = w | (1 << (rot & 31))
    return w


def probe_word(h2: torch.Tensor, num_hashes: int) -> torch.Tensor:
    """The 32-bit OR of a k-mer's probe bits from its second hash.

    Depends ONLY on h2 — filter-size independent, so one (h1, word) pair
    serves filters of any log2_m (block = h1 & (2^(log2_m-5)-1)); the
    resident pipeline caches these across passes 1-3.  Never zero, so
    callers may use word == 0 as an invalid-window sentinel."""
    return wide_to_u32(_probe_word_w(u32_to_wide(h2), num_hashes))


def probe_words_h(h1: torch.Tensor, h2: torch.Tensor, num_hashes: int,
                  log2_m: int):
    """(block int64, word int32 pattern) from precomputed (h1, h2)."""
    return _block_of(h1, log2_m), probe_word(h2, num_hashes)


def probe_words(hi: torch.Tensor, lo: torch.Tensor, num_hashes: int,
                log2_m: int):
    """(block, word) per k-mer: the packed word index and the 32-bit OR of
    its probe bits, i.e. packed[block] |= word reproduces the filter."""
    h1, h2 = _kmer_hashes_w(u32_to_wide(hi), u32_to_wide(lo))
    return probe_words_h(h1, h2, num_hashes, log2_m)


# ----------------------------------------------------------------- probe

def _query_rows_w(packed: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                  num_hashes: int) -> torch.Tensor:
    """bloom_query_rows_plain on wide (int64) lanes."""
    h1, h2 = _kmer_hashes_w(hi, lo)
    block = _block_of(h1, _log2_m_of(packed))
    off = _hash_offsets_w(h2, num_hashes)
    word = u32_to_wide(packed[block])       # one fetch per k-mer
    bits = (word[..., None] >> off) & 1
    return bits.min(dim=-1).values > 0


def bloom_query_rows_plain(packed: torch.Tensor, hi: torch.Tensor,
                           lo: torch.Tensor, num_hashes: int
                           ) -> torch.Tensor:
    """Plain PyTorch membership test: index + bit-by-bit test."""
    return _query_rows_w(packed, u32_to_wide(hi), u32_to_wide(lo),
                         num_hashes)


def bloom_query_rows(packed: torch.Tensor, hi: torch.Tensor,
                     lo: torch.Tensor, num_hashes: int) -> torch.Tensor:
    """Membership per k-mer via ONE word fetch each: bool, shape of hi.

    packed: int32 [m/32]; hi, lo: int32 patterns of the canonical k-mer.
    CUDA tensors go through the ``bloom_probe`` kernel (hashes computed
    inside it); CPU tensors through the plain version.
    """
    if packed.is_cuda:
        from .. import kernels
        return kernels.bloom_probe_hashed(packed, hi, lo, num_hashes)
    return bloom_query_rows_plain(packed, hi, lo, num_hashes)


def bloom_query_words_plain(packed: torch.Tensor, h1: torch.Tensor,
                            word: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch cached word test: index + mask compare."""
    block = _block_of(h1, _log2_m_of(packed))
    return ((packed[block] & word) == word) & (word != 0)


def bloom_query_words(packed: torch.Tensor, h1: torch.Tensor,
                      word: torch.Tensor) -> torch.Tensor:
    """Membership from the cached (h1, word) pair of each window:
    ``(packed[h1 & mask] & word) == word`` and ``word != 0`` (0 marks an
    invalid window).  Equal to the bit-by-bit test because `word` is the
    OR of the probe bits.  Same kernel as bloom_query_rows on the card.
    """
    if packed.is_cuda:
        from .. import kernels
        return kernels.bloom_probe_words(packed, h1, word)
    return bloom_query_words_plain(packed, h1, word)


# ----------------------------------------------------------------- build

def bloom_build_words_plain(h1: torch.Tensor, word: torch.Tensor,
                            keep: torch.Tensor, log2_m: int
                            ) -> torch.Tensor:
    """Plain PyTorch build: scatter ones into a bool [m] staging tensor at
    block*32 + bit for each set bit of `word`, then pack 32 bools to a
    word."""
    m = 1 << log2_m
    block = _block_of(h1, log2_m).reshape(-1)
    w = u32_to_wide(word).reshape(-1)
    keep = keep.reshape(-1)
    staging = torch.zeros(m, dtype=torch.bool, device=h1.device)
    for b in range(32):
        sel = keep & (((w >> b) & 1) != 0)
        staging[block[sel] * 32 + b] = True
    staging = staging.view(m >> 5, 32)
    packed = torch.zeros(m >> 5, dtype=torch.int64, device=h1.device)
    for b in range(32):
        packed |= staging[:, b].to(torch.int64) << b
    return wide_to_u32(packed)


def bloom_or_words_into(packed: torch.Tensor, h1: torch.Tensor,
                        word: torch.Tensor, keep: torch.Tensor
                        ) -> torch.Tensor:
    """``packed[h1 & mask] |= word`` for every entry where `keep`, IN PLACE
    on `packed` (int32 [m/32], zeroed or partly built), which it returns.
    CUDA tensors go through the ``bloom_or_words`` kernel (cached entry
    point), CPU tensors through ``bloom_build_words_plain``."""
    if packed.is_cuda:
        from .. import kernels
        return kernels.bloom_or_words(packed, h1, word, keep)
    packed |= bloom_build_words_plain(h1, word, keep, _log2_m_of(packed))
    return packed


def bloom_build_words(h1: torch.Tensor, word: torch.Tensor,
                      keep: torch.Tensor, log2_m: int) -> torch.Tensor:
    """Packed filter (int32 [m/32]) with ``packed[h1 & mask] |= word`` for
    every entry where `keep`; mask = 2^(log2_m-5) - 1, so a pre-masked
    block index may be passed as `h1` too.

    h1, word: int32 patterns, keep: bool, same shape.  OR commutes, so the
    result does not depend on the order of the entries.  CUDA tensors go
    through the ``bloom_or_words`` kernel (cached entry point: a window
    whose bits are all set already costs a read and no atomic), into a
    zeroed filter.
    """
    if h1.is_cuda:
        out = torch.zeros(1 << (log2_m - 5), dtype=torch.int32,
                          device=h1.device)
        return bloom_or_words_into(out, h1, word, keep)
    return bloom_build_words_plain(h1, word, keep, log2_m)

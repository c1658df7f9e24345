"""Pass 1 as one function: the hash cache of every window and filter A.

Counterpart of ``kbbq_tpu/pipeline/resident.py::_pass1_kmers_slice`` +
``_dense_finish``.  The hash cache is, per window, the block hash ``h1``,
the 32-bit probe ``word`` (0 = window with an N) and the sampled ``keep``
bit.  h1 masks down to ANY filter's block index and `word` depends only on
h2, so this one hash pass serves pass 1's sampled build, pass 2's filter-A
query and filter-B build, and pass 3's initial trust query.

On the card ``hash_cache_build`` is ONE launch of the fused entry point of
the ``bloom_or_words`` kernel: it reads the 1 B/base codes, writes the
cache and ORs the sampled windows into the filter, with no [rows, n]
intermediate.  Beside it ``hash_cache_chunk`` is the plain PyTorch version
of the hash pass (about 150 elementwise ops over int64 lanes); with
``bloom_build_words_plain`` it serves CPU tensors.  ``hash_cache_into``
builds into a filter the caller holds (pass 1 of the windowed engine, one
window at a time).

``hash_windows`` is the hash-only mode of the same kernel entry point
(h1 and word, no keep plane, no filter): passes 2 and 3 of the windowed
engine, where no window's cache outlives its pass, re-hash each window with
it; ``hash_windows_plain`` is its plain version.
"""

from __future__ import annotations

import torch

from .bloom import _log2_m_of, _probe_word_w, bloom_build_words_plain
from .kmers import (
    _canonical_kmers_w,
    _kmer_hashes_w,
    sample_keep_mask,
    wide_to_u32,
)

# rows per chunk of the plain version: its temporaries are ~20 int64
# [rows, n] tensors
PLAIN_CHUNK_ROWS = 65536


def _hash_pair_w(codes: torch.Tensor, k: int, num_hashes: int):
    """(h1, word, valid) of every window, wide lanes: the block hash, the
    probe word (0 where the window has an N) and validity."""
    hi, lo, valid = _canonical_kmers_w(codes, k)
    h1, h2 = _kmer_hashes_w(hi, lo)
    word = torch.where(valid, _probe_word_w(h2, num_hashes),
                       torch.zeros_like(h2))
    return h1, word, valid


def hash_cache_chunk(codes: torch.Tensor, read_ids: torch.Tensor, k: int,
                     num_hashes: int, threshold: int):
    """Plain PyTorch hash pass: (h1, word, keep) of every window of a row
    chunk, int32 patterns [B, n] and bool [B, n]; word == 0 marks an
    invalid window, whose h1 is the hash of the window with each N read as
    base 0.  read_ids: [B] global read ordinals."""
    h1, word, valid = _hash_pair_w(codes, k, num_hashes)
    keep = valid & sample_keep_mask(read_ids, valid.shape[1], threshold)
    return wide_to_u32(h1), wide_to_u32(word), keep


def hash_windows_plain(codes: torch.Tensor, k: int, num_hashes: int,
                       chunk_rows: int | None = None):
    """Plain PyTorch version of the hash-only mode: (h1, word) of
    ``hash_cache_chunk`` without the keep plane, `chunk_rows` rows at a
    time."""
    N, L = codes.shape
    n = max(L - k + 1, 0)
    rows = int(chunk_rows or PLAIN_CHUNK_ROWS)
    h1 = torch.empty((N, n), dtype=torch.int32, device=codes.device)
    word = torch.empty((N, n), dtype=torch.int32, device=codes.device)
    if n:
        for s in range(0, N, rows):
            e = min(N, s + rows)
            a, b, _ = _hash_pair_w(codes[s:e], k, num_hashes)
            h1[s:e], word[s:e] = wide_to_u32(a), wide_to_u32(b)
    return h1, word


def hash_windows(codes: torch.Tensor, k: int, num_hashes: int):
    """(h1, word) of every window of `codes` (int8 [N, L], everything past
    a read's end code 4): int32 patterns [N, n], n = max(L-k+1, 0), equal
    to the h1 and word of ``hash_cache_build``.  CUDA tensors go through
    the hash-only mode of the fused kernel entry point (one launch, none
    when N or n is 0), CPU tensors through ``hash_windows_plain``."""
    if codes.is_cuda:
        from .. import kernels
        return kernels.hash_only(codes, k, num_hashes)
    return hash_windows_plain(codes, k, num_hashes)


def hash_cache_into(codes: torch.Tensor, packed: torch.Tensor,
                    first_id: int, k: int, num_hashes: int, threshold: int,
                    chunk_rows: int | None = None):
    """The hash cache of all reads of `codes`, and the sampled windows ORed
    into `packed` IN PLACE (a filter zeroed or partly built, int32
    [2^(log2_m-5)]: OR commutes, so windows of one dataset may come in any
    order).  Arguments and result as ``hash_cache_build``, less the
    filter."""
    N, L = codes.shape
    if codes.is_cuda:
        from .. import kernels
        return kernels.hash_build(codes, packed, first_id, k, num_hashes,
                                  threshold)
    n = max(L - k + 1, 0)
    rows = int(chunk_rows or PLAIN_CHUNK_ROWS)
    h1 = torch.empty((N, n), dtype=torch.int32)
    word = torch.empty((N, n), dtype=torch.int32)
    keep = torch.empty((N, n), dtype=torch.bool)
    for s in range(0, N, rows):
        e = min(N, s + rows)
        ids = torch.arange(first_id + s, first_id + e, dtype=torch.int64)
        h1[s:e], word[s:e], keep[s:e] = hash_cache_chunk(
            codes[s:e], ids, k, num_hashes, threshold)
    packed |= bloom_build_words_plain(h1, word, keep, _log2_m_of(packed))
    return h1, word, keep


def hash_cache_build(codes: torch.Tensor, first_id: int, k: int,
                     num_hashes: int, threshold: int, log2_m: int,
                     chunk_rows: int | None = None):
    """The hash cache of all reads and the sampled filter built from it.

    codes: int8 [N, L], everything past a read's end code 4.  first_id: the
    global ordinal of read 0 (read r samples as ordinal first_id + r, by
    its low 32 bits).  threshold: inclusive keep threshold in [0, 2^32).
    Returns (h1, word, keep, packed): int32 patterns [N, n] x2, bool
    [N, n], and the packed filter int32 [2^(log2_m-5)] with
    ``packed[h1 & mask] |= word`` for every kept window; n = max(L-k+1, 0).

    CUDA tensors go through the fused kernel (one launch, none when N or n
    is 0); CPU tensors through ``hash_cache_chunk`` in chunks of
    `chunk_rows` rows and ``bloom_build_words_plain``.
    """
    packed = torch.zeros(1 << (log2_m - 5), dtype=torch.int32,
                         device=codes.device)
    h1, word, keep = hash_cache_into(codes, packed, first_id, k, num_hashes,
                                     threshold, chunk_rows)
    return h1, word, keep, packed

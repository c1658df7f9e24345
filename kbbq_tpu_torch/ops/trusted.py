"""Pass-2 tensor ops: coverage rule + trusted-k-mer mask (D6).

Counterpart of ``kbbq_tpu/ops/trusted.py``.  Sliding-window sums are
prefix-sum differences (integer adds: exact, order-invariant); the
threshold lookup ``thresholds[x]`` is a plain index.

``trusted_from_cache`` is pass 2's trust decision from the hash cache.  On
the card it is ONE launch of the ``bloom_probe`` kernel's fused entry point
(``kernels.bloom_probe_trust``: probe and rule in the block that probed, no
plane of hits); ``trusted_from_cache_plain`` beside it is the plain PyTorch
version (the cached word test, then ``trusted_mask_batch``, by row chunks)
and serves CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .bloom import bloom_query_words_plain

# rows per chunk of the plain version: its temporaries are a few int32
# [rows, n + 2k] tensors
PLAIN_CHUNK_ROWS = 65536


def _window_sum_full(x: torch.Tensor, k: int) -> torch.Tensor:
    """Full-convolution sliding sum: out[i] = sum x[j], j in [i-k+1, i]
    clipped to [0, n).  x: int32 [B, n] -> int32 [B, n+k-1]."""
    cs = F.pad(F.pad(x, (k - 1, k - 1)).cumsum(1, dtype=torch.int32), (1, 0))
    return cs[:, k:] - cs[:, :-k]


def _window_sum_valid(x: torch.Tensor, k: int) -> torch.Tensor:
    """Valid-convolution sliding sum: out[j] = sum x[j..j+k-1].
    x: int32 [B, L] -> int32 [B, L-k+1]."""
    cs = F.pad(x.cumsum(1, dtype=torch.int32), (1, 0))
    return cs[:, k:] - cs[:, :x.shape[1] - k + 1]


def coverage_counts(hits: torch.Tensor, valid: torch.Tensor, k: int):
    """(s, x) per base: A-positive / valid overlapping-window counts.

    hits, valid: bool [B, n] per-window; returns int32 [B, L] each
    (L = n+k-1).  Matches the oracle's full-mode convolutions.
    """
    s = _window_sum_full(hits.to(torch.int32), k)
    x = _window_sum_full(valid.to(torch.int32), k)
    return s, x


def trusted_mask_batch(hits: torch.Tensor, valid: torch.Tensor,
                       thresholds: torch.Tensor, k: int,
                       trust_threshold: int | None = None) -> torch.Tensor:
    """Pass-2 trusted mask per window (D6).

    Args:
      hits: bool [B, n] filter-A membership per window.
      valid: bool [B, n] window validity.
      thresholds: integer [k+1] coverage threshold table t(x)
        (host-computed, oracle coverage_thresholds).
    Returns: bool [B, n].
    """
    s, x = coverage_counts(hits, valid, k)
    covered = s >= thresholds[x.long()]
    T = k if trust_threshold is None else trust_threshold
    covc = _window_sum_valid(covered.to(torch.int32), k)
    return valid & (covc >= T)


def trusted_from_cache_plain(packed: torch.Tensor, h1: torch.Tensor,
                             word: torch.Tensor, thresholds: torch.Tensor,
                             k: int, trust_threshold: int | None = None,
                             out: torch.Tensor | None = None,
                             chunk_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch pass-2 trust from the hash cache: the cached word test
    against `packed`, then the coverage rule, `chunk_rows` rows at a time
    (the result does not depend on it)."""
    N, n = h1.shape
    if out is None:
        out = torch.empty((N, n), dtype=torch.bool, device=h1.device)
    if n == 0:
        return out
    rows = int(chunk_rows or PLAIN_CHUNK_ROWS)
    for s in range(0, N, rows):
        e = min(N, s + rows)
        hits = bloom_query_words_plain(packed, h1[s:e], word[s:e])
        out[s:e] = trusted_mask_batch(hits, word[s:e] != 0, thresholds, k,
                                      trust_threshold)
    return out


def trusted_from_cache(packed: torch.Tensor, h1: torch.Tensor,
                       word: torch.Tensor, thresholds: torch.Tensor, k: int,
                       trust_threshold: int | None = None,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Trusted bit of every window from its cached (h1, word) pair (D6).

    packed: filter A, int32 [m/32]; h1, word: int32 patterns [N, n], word
    == 0 marking a window with an N; thresholds: integer [k+1], t(x);
    trust_threshold None means k.  Returns bool [N, n]; with `out` the
    result is written into that tensor, which is returned.  CUDA tensors go
    through one launch of the fused kernel entry point; CPU tensors through
    the plain version.
    """
    if packed.is_cuda:
        from .. import kernels
        T = k if trust_threshold is None else trust_threshold
        return kernels.bloom_probe_trust(
            packed, h1, word, thresholds.to(torch.int32), k, T, out=out)
    return trusted_from_cache_plain(packed, h1, word, thresholds, k,
                                    trust_threshold, out=out)

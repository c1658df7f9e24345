"""Pass-2 tensor ops: coverage rule + trusted-k-mer mask (D6).

Counterpart of ``kbbq_tpu/ops/trusted.py``.  Sliding-window sums are
prefix-sum differences (integer adds: exact, order-invariant); the
threshold lookup ``thresholds[x]`` is a plain index.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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

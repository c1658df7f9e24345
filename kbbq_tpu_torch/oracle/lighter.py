"""Oracle Lighter-style trusted k-mers and per-read error inference.

Copy of ``kbbq_tpu/oracle/lighter.py`` (DECISIONS.md D6/D7): the coverage
thresholds of the pass-2 trust rule (a scipy binomial-tail sweep on the
host, identical in every pipeline), the per-base coverage mask, the
trusted k-mer mask and the correction walk.  Loop-first for clarity; the
device path (``ops/trusted.py``, ``ops/inference.py`` and the kernels
behind them) implements the same recurrences and is held to these.
"""

from __future__ import annotations

import functools

import numpy as np

from ..constants import BASE_N, DEFAULT_EXT_CAP, P_FALSE_COVER
from .bloom import OracleBloom
from .kmers import canonical_kmers


def _window_kmer(codes: np.ndarray, j: int, k: int):
    """Canonical (hi, lo, valid) for the single window at offset j."""
    hi, lo, valid = canonical_kmers(codes[j:j + k], k)
    return hi[0], lo[0], bool(valid[0])


def _query_window(bloom: OracleBloom, codes: np.ndarray, j: int, k: int) -> bool:
    hi, lo, valid = _window_kmer(codes, j, k)
    if not valid:
        return False
    return bool(bloom.query(np.array([hi]), np.array([lo]))[0])


@functools.lru_cache(maxsize=64)
def _coverage_thresholds_cached(alpha: float, k: int,
                                p_false: float) -> tuple:
    return tuple(int(v) for v in
                 _coverage_thresholds_impl(alpha, k, p_false))


def coverage_thresholds(alpha: float, k: int,
                        p_false: float = P_FALSE_COVER) -> np.ndarray:
    """t(x) for x in 0..k (DECISIONS.md D6).

    t(x) = min { t : P[Binom(x, alpha) >= t] <= p_false }; may be x+1
    (position can never be covered).  t(0) = 1 (an overlap-free position is
    never covered).  Memoized: the pipeline calls it with the same
    (alpha, k) on every run.
    """
    return np.array(_coverage_thresholds_cached(float(alpha), int(k),
                                                float(p_false)),
                    dtype=np.int64)


def _coverage_thresholds_impl(alpha: float, k: int,
                              p_false: float) -> np.ndarray:
    from scipy.stats import binom

    t = np.zeros(k + 1, dtype=np.int64)
    for x in range(k + 1):
        # P[Binom(x, a) >= tt] = sf(tt - 1)
        tt = x + 1
        for cand in range(0, x + 2):
            if binom.sf(cand - 1, x, alpha) <= p_false:
                tt = cand
                break
        t[x] = max(1, tt)
    return t


def coverage_mask(codes: np.ndarray, k: int, sampled: OracleBloom,
                  alpha: float) -> np.ndarray:
    """Per-base covered flag per DECISIONS.md D6 (binomial-tail rule)."""
    L = codes.shape[0]
    cov = np.zeros(L, dtype=bool)
    hi, lo, valid = canonical_kmers(codes, k)
    n = hi.size
    if n == 0:
        return cov
    hits = np.zeros(n, dtype=np.int64)
    if valid.any():
        hits[valid] = sampled.query(hi[valid], lo[valid]).astype(np.int64)
    ones = np.ones(k, dtype=np.int64)
    # windows j overlapping base i: j in [i-k+1, i] clipped to [0, n).
    # full-mode convolution has length n+k-1 == L and full[i] sums hits[j]
    # for j in [i-k+1, i] — exactly the overlap window of base i.
    s = np.convolve(hits, ones, mode="full")
    x = np.convolve(valid.astype(np.int64), ones, mode="full")
    assert s.shape[0] == L
    t = coverage_thresholds(alpha, k)
    return s >= t[x]


def trusted_kmer_mask(codes: np.ndarray, k: int, sampled: OracleBloom,
                      alpha: float,
                      trust_threshold: int | None = None) -> np.ndarray:
    """Pass-2 rule: k-mer trusted iff >= T of its bases are covered (T=k)."""
    cov = coverage_mask(codes, k, sampled, alpha)
    L = codes.shape[0]
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, dtype=bool)
    T = k if trust_threshold is None else trust_threshold
    _, _, valid = canonical_kmers(codes, k)
    covc = np.convolve(cov.astype(np.int64), np.ones(k, dtype=np.int64),
                       mode="valid")
    return valid & (covc >= T)


def _longest_true_run(mask: np.ndarray):
    """(start, end) inclusive of the longest run of True; ties -> leftmost.

    Returns (-1, -1) if no True.
    """
    best_s = best_e = -1
    best_len = 0
    s = -1
    for i, v in enumerate(mask):
        if v and s < 0:
            s = i
        if (not v or i == len(mask) - 1) and s >= 0:
            e = i if v else i - 1
            if e - s + 1 > best_len:
                best_len, best_s, best_e = e - s + 1, s, e
            s = -1
    return best_s, best_e


def infer_read_errors(codes: np.ndarray, k: int, trusted: OracleBloom,
                      ext_cap: int | None = None) -> np.ndarray:
    """Error mask per base (DECISIONS.md D7). Does not mutate `codes`.

    ext_cap overrides the trial-extension cap W (None -> DEFAULT_EXT_CAP;
    the reference extends to k — pass ext_cap=k for reference semantics)."""
    codes = np.asarray(codes, dtype=np.int8)
    L = codes.shape[0]
    errors = np.zeros(L, dtype=bool)
    n = L - k + 1
    if n <= 0:
        return errors

    work = codes.copy()
    hi, lo, valid = canonical_kmers(work, k)
    tr = np.zeros(n, dtype=bool)
    if valid.any():
        tr[valid] = trusted.query(hi[valid], lo[valid])
    if not valid.any() or tr[valid].all():
        return errors
    a, b = _longest_true_run(tr)
    if a < 0:
        return errors  # no anchor: totals only (D7 step 3)

    W = min(ext_cap if ext_cap is not None else DEFAULT_EXT_CAP, k)

    def ext_right(j: int) -> int:
        """# consecutive trusted k-mers starting at j on work seq, cap W
        (DECISIONS.md D7; W = DEFAULT_EXT_CAP)."""
        cnt = 0
        for jj in range(j, min(j + W, n)):
            if not _query_window(trusted, work, jj, k):
                break
            cnt += 1
        return cnt

    def ext_left(j: int) -> int:
        cnt = 0
        for jj in range(j, max(j - W, -1), -1):
            if not _query_window(trusted, work, jj, k):
                break
            cnt += 1
        return cnt

    def _window_valid(j: int) -> bool:
        return not (work[j:j + k] == BASE_N).any()

    # rightward walk (D7 step 4)
    j = b + 1
    while j < n:
        if not _window_valid(j):
            j += 1
            continue
        if _query_window(trusted, work, j, k):
            j += 1
            continue
        p = j + k - 1  # base newly entering k-mer j
        orig = work[p]
        best_c, best_ext = -1, 0
        for c in range(4):
            if c == orig:
                continue
            work[p] = c
            e = ext_right(j)
            if e > best_ext:
                best_ext, best_c = e, c
        work[p] = orig
        errors[p] = True
        if best_ext >= 1:
            work[p] = best_c
            j += best_ext
        else:
            j += 1

    # leftward walk (D7 step 5)
    j = a - 1
    while j >= 0:
        if not _window_valid(j):
            j -= 1
            continue
        if _query_window(trusted, work, j, k):
            j -= 1
            continue
        p = j  # base newly entering at the left end
        orig = work[p]
        best_c, best_ext = -1, 0
        for c in range(4):
            if c == orig:
                continue
            work[p] = c
            e = ext_left(j)
            if e > best_ext:
                best_ext, best_c = e, c
        work[p] = orig
        errors[p] = True
        if best_ext >= 1:
            work[p] = best_c
            j -= best_ext
        else:
            j -= 1

    return errors

"""Coverage thresholds of the pass-2 trust rule (DECISIONS.md D6).

Copy of ``coverage_thresholds`` of ``kbbq_tpu/oracle/lighter.py``: a scipy
binomial-tail sweep on the host, identical in every pipeline.
"""

from __future__ import annotations

import functools

import numpy as np

from ..constants import P_FALSE_COVER


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

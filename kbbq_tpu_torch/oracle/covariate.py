"""Oracle covariate tables (DECISIONS.md D8; SURVEY.md Appendix A.3).

Copy of ``kbbq_tpu/oracle/covariate.py``.  Tables are dense int64 (total,
errors) arrays:

  T_Cyc[rg, q, cycle_idx]  — every non-skipped base
  T_Din[rg, q, dinuc]      — non-skipped bases with a valid dinuc context

T_Q and T_RG are exact marginalizations of T_Cyc (every non-skipped base has
a valid cycle), which is also how the device path derives them — integer
adds commute, so sharding cannot change the result (SURVEY.md H5).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import (
    BASE_N,
    DINUC_INVALID,
    MIN_USABLE_Q,
    NUM_DINUC,
    NUM_Q,
    cycle_to_index,
)


@dataclasses.dataclass
class CovariateTables:
    """Dense covariate counters for `num_rg` read groups, reads <= max_len."""

    num_rg: int
    max_len: int
    cyc_total: np.ndarray = None  # [rg, NUM_Q, 2*max_len] int64
    cyc_errors: np.ndarray = None
    din_total: np.ndarray = None  # [rg, NUM_Q, NUM_DINUC] int64
    din_errors: np.ndarray = None

    def __post_init__(self):
        nc = 2 * self.max_len
        if self.cyc_total is None:
            self.cyc_total = np.zeros((self.num_rg, NUM_Q, nc), dtype=np.int64)
            self.cyc_errors = np.zeros_like(self.cyc_total)
            self.din_total = np.zeros((self.num_rg, NUM_Q, NUM_DINUC), dtype=np.int64)
            self.din_errors = np.zeros_like(self.din_total)

    # marginalizations -----------------------------------------------------
    def q_total(self):
        return self.cyc_total.sum(axis=2)

    def q_errors(self):
        return self.cyc_errors.sum(axis=2)

    def rg_total(self):
        return self.cyc_total.sum(axis=(1, 2))

    def rg_errors(self):
        return self.cyc_errors.sum(axis=(1, 2))

    def merge(self, other: "CovariateTables") -> "CovariateTables":
        assert (self.num_rg, self.max_len) == (other.num_rg, other.max_len)
        return CovariateTables(
            self.num_rg, self.max_len,
            self.cyc_total + other.cyc_total,
            self.cyc_errors + other.cyc_errors,
            self.din_total + other.din_total,
            self.din_errors + other.din_errors,
        )


def compute_skips(codes: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """Base skipped iff N or reported q < MIN_USABLE_Q (D8)."""
    return (codes == BASE_N) | (quals < MIN_USABLE_Q)


def dinuc_indices(codes: np.ndarray) -> np.ndarray:
    """Per-base dinuc index prev*4+cur; DINUC_INVALID at i==0 or N-adjacent."""
    codes = np.asarray(codes, dtype=np.int64)
    L = codes.shape[0]
    out = np.full(L, DINUC_INVALID, dtype=np.int64)
    if L >= 2:
        prev, cur = codes[:-1], codes[1:]
        ok = (prev != BASE_N) & (cur != BASE_N)
        out[1:][ok] = prev[ok] * 4 + cur[ok]
    return out


def cycle_indices(L: int, second: bool) -> np.ndarray:
    """Per-base cycle table index (D8)."""
    i = np.arange(L, dtype=np.int64)
    cyc = -(i + 1) if second else (i + 1)
    return cycle_to_index(cyc)


def accumulate_read(tables: CovariateTables, codes: np.ndarray,
                    quals: np.ndarray, errors: np.ndarray,
                    rg: int, second: bool) -> None:
    """Scatter one read's non-skipped bases into the tables."""
    codes = np.asarray(codes, dtype=np.int64)
    quals = np.asarray(quals, dtype=np.int64)
    L = codes.shape[0]
    skips = compute_skips(codes, quals)
    use = ~skips
    q = np.clip(quals, 0, NUM_Q - 1)
    cyc = cycle_indices(L, second)
    din = dinuc_indices(codes)
    err = np.asarray(errors, dtype=bool)

    for i in np.nonzero(use)[0]:
        tables.cyc_total[rg, q[i], cyc[i]] += 1
        if err[i]:
            tables.cyc_errors[rg, q[i], cyc[i]] += 1
        if din[i] != DINUC_INVALID:
            tables.din_total[rg, q[i], din[i]] += 1
            if err[i]:
                tables.din_errors[rg, q[i], din[i]] += 1

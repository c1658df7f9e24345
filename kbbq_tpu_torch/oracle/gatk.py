"""GATK-compatible empirical quality + hierarchical deltas (DECISIONS.md D9).

Copy of ``kbbq_tpu/oracle/gatk.py``, unchanged in its arithmetic so that the
Q' table is identical.  This runs on the HOST in float64: the merged integer
tables are tiny, and keeping all float math off the device makes device
output bit-exact by construction (the device applies a precomputed int8
lookup table).
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln

from ..constants import (
    DINUC_INVALID,
    MAX_Q,
    NUM_DINUC,
    NUM_Q,
    PRIOR_SIGMA,
    RECAL_MIN_Q,
)
from .covariate import CovariateTables

_LN10 = np.log(10.0)
_QS = np.arange(NUM_Q, dtype=np.float64)          # candidate empirical Qs
_P_ERR = np.power(10.0, -_QS / 10.0)              # error prob per candidate
_P_ERR = np.clip(_P_ERR, 1e-10, 1.0 - 1e-10)
_LOG10_P = np.log10(_P_ERR)
_LOG10_1MP = np.log10(1.0 - _P_ERR)


def log10_prior(delta: np.ndarray) -> np.ndarray:
    """log10 of unnormalized Gaussian(0, PRIOR_SIGMA) at `delta` (D9)."""
    d = np.asarray(delta, dtype=np.float64)
    return -(d * d) / (2.0 * PRIOR_SIGMA * PRIOR_SIGMA) / _LN10


def empirical_quality(errors, total, prior) -> np.ndarray:
    """Bayesian empirical quality per cell; broadcasts over leading dims.

    empQ = argmax_q [ log10_prior(q - prior) + log10 Binom(e | n, p_q) ],
    ties -> smallest q; cells with n == 0 -> round(prior) (half-even).
    """
    e = np.asarray(errors, dtype=np.float64)
    n = np.asarray(total, dtype=np.float64)
    pr = np.asarray(prior, dtype=np.float64)
    e, n, pr = np.broadcast_arrays(e, n, pr)
    # n == 0 cells take the prior; the likelihood is evaluated only on
    # occupied cells (most covariate cells are empty on real data — the
    # compaction is a big host-time win and bit-exact: kept cells see
    # the identical elementwise float64 ops, so the argmax is unchanged)
    out = np.clip(np.round(pr), 0.0, float(MAX_Q))
    nz = np.flatnonzero(n.ravel() > 0)
    if nz.size:
        ef = e.reshape(-1)[nz]
        nf = n.reshape(-1)[nz]
        pf = pr.reshape(-1)[nz]
        # log-likelihood per candidate q: [cells, NUM_Q]
        log10_nck = (gammaln(nf + 1.0) - gammaln(ef + 1.0)
                     - gammaln(nf - ef + 1.0)) / _LN10
        ll = (log10_nck[..., None]
              + ef[..., None] * _LOG10_P
              + (nf - ef)[..., None] * _LOG10_1MP)
        post = log10_prior(_QS - pf[..., None]) + ll
        emp = np.argmax(post, axis=-1).astype(np.float64)  # ties: first
        out.reshape(-1)[nz] = emp
    return out


def _mean_reported_q(q_total: np.ndarray) -> np.ndarray:
    """Expected-error-weighted mean reported Q per rg (float, not rounded)."""
    n = q_total.sum(axis=1)
    p = np.power(10.0, -np.arange(NUM_Q, dtype=np.float64) / 10.0)
    exp_err = (q_total * p).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        meanq = -10.0 * np.log10(exp_err / np.maximum(n, 1))
    return np.where(n > 0, meanq, 0.0)


def compute_deltas(tables: CovariateTables):
    """Hierarchical ΔRG / ΔQ / ΔCyc / ΔDin per DECISIONS.md D9.

    Returns dict with float64 arrays:
      mean_q   [rg]
      delta_rg [rg]
      delta_q  [rg, NUM_Q]
      delta_cyc[rg, NUM_Q, 2*max_len]
      delta_din[rg, NUM_Q, NUM_DINUC]
    Empty cells contribute delta 0 at their own level.
    """
    qt, qe = tables.q_total(), tables.q_errors()
    rgt, rge = tables.rg_total(), tables.rg_errors()

    mean_q = _mean_reported_q(qt)                        # [rg]
    emp_rg = empirical_quality(rge, rgt, mean_q)
    delta_rg = np.where(rgt > 0, emp_rg - mean_q, 0.0)   # [rg]

    prior_q = (np.arange(NUM_Q, dtype=np.float64)[None, :]
               + delta_rg[:, None])                      # [rg, Q]
    emp_q = empirical_quality(qe, qt, prior_q)
    delta_q = np.where(qt > 0, emp_q - prior_q, 0.0)

    prior_cov = prior_q + delta_q                        # [rg, Q]
    emp_cyc = empirical_quality(tables.cyc_errors, tables.cyc_total,
                                prior_cov[..., None])
    delta_cyc = np.where(tables.cyc_total > 0,
                         emp_cyc - prior_cov[..., None], 0.0)
    emp_din = empirical_quality(tables.din_errors, tables.din_total,
                                prior_cov[..., None])
    delta_din = np.where(tables.din_total > 0,
                         emp_din - prior_cov[..., None], 0.0)

    return {
        "mean_q": mean_q,
        "delta_rg": delta_rg,
        "delta_q": delta_q,
        "delta_cyc": delta_cyc,
        "delta_din": delta_din,
    }


# table capture: every pipeline funnels its merged host-side
# CovariateTables through build_recal_table, so capturing here needs no
# per-pipeline plumbing (used by report interop)
_table_capture: dict | None = None


class captured_tables:
    """Context manager: `with captured_tables() as cap:` then read
    cap["tables"] (the CovariateTables of the last recal-table build)."""

    def __enter__(self):
        global _table_capture
        self._prev = _table_capture
        _table_capture = self._cap = {}
        return self._cap

    def __exit__(self, *exc):
        global _table_capture
        _table_capture = self._prev
        return False


def note_tables(tables: CovariateTables) -> None:
    """Hand `tables` to an open ``captured_tables`` (a table built in
    another process, by rank 0 of a group, is noted by its caller)."""
    if _table_capture is not None:
        _table_capture["tables"] = tables


def build_recal_table(tables: CovariateTables) -> np.ndarray:
    """Dense final-quality lookup Q'[rg, q, cycle_idx, dinuc(17)] int8 (D10).

    q' = clamp(round(q + ΔRG + ΔQ + ΔCyc + ΔDin), RECAL_MIN_Q, MAX_Q) with
    round-half-even; dinuc index DINUC_INVALID contributes ΔDin = 0.  The
    device recalibration pass is a pure gather over this table.
    """
    note_tables(tables)
    d = compute_deltas(tables)
    rg_n = tables.num_rg
    nc = 2 * tables.max_len
    q = np.arange(NUM_Q, dtype=np.float64)
    base = (q[None, :] + d["delta_rg"][:, None] + d["delta_q"])  # [rg, Q]
    din = np.concatenate(
        [d["delta_din"], np.zeros((rg_n, NUM_Q, 1))], axis=2)    # [rg,Q,17]
    out = (base[:, :, None, None]
           + d["delta_cyc"][:, :, :, None]
           + din[:, :, None, :])                                 # [rg,Q,C,17]
    out = np.clip(np.round(out), RECAL_MIN_Q, MAX_Q)
    assert out.shape == (rg_n, NUM_Q, nc, NUM_DINUC + 1)
    return out.astype(np.int8)

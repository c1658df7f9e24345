"""Pass-4 tensor op: recalibrated quality assignment (D10).

Counterpart of ``kbbq_tpu/ops/recal.py::apply_recal_table``: all float delta
math happens on the host in float64 (oracle/gatk.py) and produces a dense
int8 table Q'[rg, q, cycle_idx, dinuc(17)]; the device does one flat
integer gather per base.
"""

from __future__ import annotations

import torch

from .covariate import base_covariates


def apply_recal_table(recal: torch.Tensor, codes: torch.Tensor,
                      quals: torch.Tensor, mask: torch.Tensor,
                      rgs: torch.Tensor, seconds: torch.Tensor
                      ) -> torch.Tensor:
    """New per-base qualities: int8 [B, L].

    recal: int8 [num_rg, NUM_Q, 2*max_len, 17]; skipped bases keep their
    original reported quality.
    """
    cv = base_covariates(codes, quals, mask, seconds)
    rg = rgs.to(torch.int64)[:, None]
    nrg, nq, nc, nd = recal.shape
    # DINUC_INVALID (=16) indexes the zero-delta column
    flat = ((rg * nq + cv["q"]) * nc + cv["cyc"]) * nd + cv["din"]
    out = recal.reshape(-1)[flat]
    return torch.where(cv["skip"], quals.to(torch.int8), out)

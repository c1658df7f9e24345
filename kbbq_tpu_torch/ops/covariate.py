"""Pass-3 tensor ops: covariate histogram (D8).

Counterpart of ``kbbq_tpu/ops/covariate.py`` and ``ops/covariate_host.py``:
the same counts, taken as ``torch.bincount`` over int64 flat indices on the
device.  Integer +1 adds commute, so any chunking or order gives identical
tables.
"""

from __future__ import annotations

import torch

from ..constants import (
    DINUC_INVALID,
    MIN_USABLE_Q,
    NUM_DINUC,
    NUM_Q,
)


def new_covariate_state(num_rg: int, max_len: int, device) -> dict:
    """Zeroed tables on `device`: dict of int64 tensors."""
    nc = 2 * max_len

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)

    return {
        "cyc_total": z(num_rg, NUM_Q, nc),
        "cyc_errors": z(num_rg, NUM_Q, nc),
        "din_total": z(num_rg, NUM_Q, NUM_DINUC),
        "din_errors": z(num_rg, NUM_Q, NUM_DINUC),
    }


def base_covariates(codes: torch.Tensor, quals: torch.Tensor,
                    mask: torch.Tensor, seconds: torch.Tensor) -> dict:
    """Per-base covariate indices for a batch.

    Args:
      codes: int8 [B, L]; quals: int8 [B, L]; mask: bool [B, L] real-base;
      seconds: bool [B] second-in-pair.
    Returns dict: skip [B,L] bool, q / cyc / din [B,L] int64.
    """
    B, L = codes.shape
    c = codes.to(torch.int64)
    q0 = quals.to(torch.int64)
    skip = (~mask) | (c == 4) | (q0 < MIN_USABLE_Q)
    q = q0.clamp(0, NUM_Q - 1)

    i = torch.arange(L, dtype=torch.int64, device=codes.device)[None, :]
    cyc = i * 2 + seconds.to(torch.int64)[:, None]

    prev = torch.nn.functional.pad(c[:, :-1], (1, 0), value=4)
    din_ok = (prev != 4) & (c != 4) & (i > 0)
    din = torch.where(din_ok, prev * 4 + c,
                      torch.full_like(c, DINUC_INVALID))
    return {"skip": skip, "q": q, "cyc": cyc, "din": din}


def accumulate_covariates(state: dict, codes: torch.Tensor,
                          quals: torch.Tensor, mask: torch.Tensor,
                          rgs: torch.Tensor, seconds: torch.Tensor,
                          errors: torch.Tensor) -> dict:
    """Add one batch's counts to the tables of `state`, IN PLACE (the
    tables are updated rather than copied: they are the only state carried
    across row chunks); returns `state`.
    """
    cv = base_covariates(codes, quals, mask, seconds)
    use = ~cv["skip"]
    err = errors & use
    nc = state["cyc_total"].shape[2]
    rgq = rgs.to(torch.int64)[:, None] * NUM_Q + cv["q"]

    def hist(flat, where, table):
        table += torch.bincount(flat[where],
                                minlength=table.numel()).view(table.shape)

    flat_cyc = rgq * nc + cv["cyc"]
    hist(flat_cyc, use, state["cyc_total"])
    hist(flat_cyc, err, state["cyc_errors"])
    din_ok = use & (cv["din"] != DINUC_INVALID)
    # invalid dinucs are masked out, so their (out of range) index is never read
    flat_din = rgq * NUM_DINUC + cv["din"]
    hist(flat_din, din_ok, state["din_total"])
    hist(flat_din, err & din_ok, state["din_errors"])
    return state

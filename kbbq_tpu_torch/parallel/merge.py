"""The merges at the pass boundaries of the replicated layout.

The JAX package merges inline (``kbbq_tpu/parallel/resident_sharded.py``'s
``_or_merge``: an all-gather of every replica and an OR fold, inside a
shard_map).  Here, between the ranks of a ``torch.distributed`` group:

- ``or_merge``: the OR of every rank's packed filter.  NCCL has no bitwise
  reduction (``ReduceOp.BOR`` is gloo's and MPI's only) and reduces no bool
  tensor, so one code path serves both backends: an ``all_to_all_single``
  hands rank r the r-th of D slices of every rank's words, the rank ORs the
  D slices it received, and an all-gather gives every rank the whole
  filter.  Per rank that moves 2(D-1)/D of the filter, against (D-1) times
  the filter for an all-gather and fold.  The word count is padded to a
  multiple of D (a filter may have fewer words than there are ranks).
- ``sum_merge``: the covariate histograms, int64, summed by one
  ``all_reduce`` over the four tables laid end to end.
- ``broadcast_table``: the delta math (float64, ``oracle/gatk.py``) runs once,
  on rank 0, which broadcasts the int8 Q' table.

OR and integer adds commute, so every merge gives the one-device bits.
Each call adds its seconds (between two synchronises on a card, so the
pass's own queued work is not counted) and the bytes it sent from this
rank to ``rank.stats``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..constants import NUM_DINUC, NUM_Q

COV_NAMES = ("cyc_total", "cyc_errors", "din_total", "din_errors")


def _sync(rank) -> None:
    if rank.device.type == "cuda":
        torch.cuda.synchronize(rank.device)


def _start(rank) -> float:
    """The merge's clock starts once the rank's queued work is done."""
    _sync(rank)
    return time.time()


def _account(rank, t0: float, sent: int) -> None:
    _sync(rank)
    rank.stats["merge"] += time.time() - t0
    rank.stats["merge_bytes"] += int(sent)


def or_merge(rank, words: torch.Tensor) -> torch.Tensor:
    """The OR over every rank of `words` (int32 [W], on the rank's device,
    the same W on every rank) -> int32 [W], the same on every rank."""
    t0 = _start(rank)
    D = rank.world
    W = int(words.numel())
    per = -(-W // D)
    src = words.contiguous()
    if per * D != W:
        src = torch.cat([src, src.new_zeros(per * D - W)])
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src)
    parts = recv.view(D, per)
    acc = parts[0].clone()
    for j in range(1, D):
        torch.bitwise_or(acc, parts[j], out=acc)
    out = torch.empty_like(src)
    # the list form: all_gather_into_tensor is deprecated in newer torch,
    # and its successor is missing from older releases
    dist.all_gather(list(out.view(D, per).unbind(0)), acc)
    _account(rank, t0, 2 * (D - 1) * per * 4)
    return out[:W] if per * D != W else out


def sum_merge(rank, cov: dict) -> dict:
    """The four int64 covariate tables of `cov` (``new_covariate_state``'s
    dict, on the rank's device) summed over every rank, in place; returns
    `cov`."""
    t0 = _start(rank)
    flat = torch.cat([cov[n].reshape(-1) for n in COV_NAMES])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    s = 0
    for n in COV_NAMES:
        e = s + cov[n].numel()
        cov[n].copy_(flat[s:e].view_as(cov[n]))
        s = e
    # a ring all-reduce sends 2(D-1)/D of the buffer from each rank
    _account(rank, t0, 2 * (rank.world - 1) * flat.numel() * 8 // rank.world)
    return cov


def broadcast_table(rank, recal: np.ndarray | None, num_rg: int,
                    max_len: int) -> np.ndarray:
    """Rank 0's int8 Q' table [num_rg, NUM_Q, 2*max_len, NUM_DINUC+1]
    (`recal`; None on the other ranks) on every rank."""
    t0 = _start(rank)
    shape = (num_rg, NUM_Q, 2 * max_len, NUM_DINUC + 1)
    if rank.rank == 0:
        t = torch.from_numpy(np.ascontiguousarray(recal)).to(rank.device)
    else:
        t = torch.empty(shape, dtype=torch.int8, device=rank.device)
    dist.broadcast(t, 0)
    _account(rank, t0, t.numel() * (rank.world - 1 if rank.rank == 0 else 0))
    return t.cpu().numpy()

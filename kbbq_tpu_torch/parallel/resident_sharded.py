"""The resident path over the ranks of a group.

Counterpart of ``kbbq_tpu/parallel/resident_sharded.py::
recalibrate_arrays_resident_sharded`` (the replicated layout) and of
``kbbq_tpu/parallel/sharded_bloom.py::sharded_bloom_recalibrate_arrays``
(the hash-space-sharded one): ``pipeline/resident.py``'s four passes, each
rank on its contiguous share of the rows.  With the replicated layout every
rank holds whole filters:

  pass 1  hash cache of the rank's rows with ``first_id`` = the global
          ordinal of its first row (sampling keys on it, DECISIONS D5),
          then filter A = ``or_merge`` of the ranks' filters
  pass 2  trust against the merged A, the local build of B, ``or_merge``
  pass 3  initial trust, walks and histogram on the rank's rows, then
          ``sum_merge`` of the tables
  deltas  on rank 0, the Q' table broadcast
  pass 4  the local gather, written into the caller's rows

With the sharded layout each rank holds 1/D of each filter
(``sharded_bloom.ShardedFilter``) and no filter is merged:

  pass 1  hash cache and keep plane (the fused kernel's keep mode), the kept
          windows routed to filter A's owners
  pass 2  the collective word test against A, the trust rule on its hits
          (the probe kernel's rule-only entry point), the trusted windows
          routed to filter B's owners
  pass 3  the collective word test against B for the initial trust, then
          per row chunk (as many on every rank) the round-based walk, whose
          every round asks B's owners

The input rows reach the ranks through ``mesh.SharedArrays`` and the output
rows come back the same way.  The result does not depend on the number of
ranks: OR and integer adds commute.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..io.batcher import ReadArrays
from ..oracle.bloom import check_layout_capacity
from ..oracle.kmers import alpha_threshold
from ..oracle.lighter import coverage_thresholds
from ..oracle.pipeline import bloom_params_for
from .mesh import SharedArrays, launch, row_range, slowest

FIELDS = ("codes", "quals", "mask", "rgs", "seconds")


@dataclasses.dataclass
class Plan:
    """What every rank needs of the whole dataset, computed once by the
    caller: its shape, the sampling threshold and both filters' sizes."""

    num_reads: int
    max_len: int
    num_rg: int
    total_bases: int
    total_kmers: int
    alpha: float
    log2_ma: int
    log2_mb: int
    layout: str = "replicated"


def plan_for(arrays: ReadArrays, config, layout: str = "replicated",
             devices: int = 1) -> Plan:
    """The ``Plan`` of `arrays` under `config` and the Bloom `layout` on
    `devices` ranks: the sharded layout's sizes are bumped
    (``sharded_bloom.sharded_params``); refuses filters the layout cannot
    hold (``check_layout_capacity``)."""
    k = config.k
    lens = arrays.mask.sum(axis=1)
    total_bases = int(lens.sum())
    total_kmers = int(np.maximum(lens - k + 1, 0).sum())
    alpha, coverage = config.resolve_alpha(total_bases)
    if layout == "sharded":
        from .sharded_bloom import sharded_params
        pa, pb = sharded_params(config, total_kmers, alpha, coverage,
                                devices)
    else:
        pa, pb = bloom_params_for(config, total_kmers, alpha, coverage)
        for p in (pa, pb):
            # every rank holds both filters whole, as packed words
            check_layout_capacity(p, 33, "replicated resident",
                                  "use --bloom-layout sharded")
    return Plan(arrays.num_reads, arrays.max_len,
                int(arrays.rgs.max(initial=0)) + 1, total_bases, total_kmers,
                alpha, pa.log2_m, pb.log2_m, layout)


def share_arrays(arrays: ReadArrays) -> SharedArrays:
    """`arrays` in memory-mapped files for the ranks, beside an empty
    int8 [N, L] output ``out``."""
    shared = SharedArrays()
    try:
        for name in FIELDS:
            shared.put(name, getattr(arrays, name))
        shared.empty("out", (arrays.num_reads, arrays.max_len), np.int8)
    except BaseException:
        shared.close()
        raise
    return shared


def shared_rows(shared: SharedArrays, s: int, e: int) -> ReadArrays:
    """Rows [s, e) of the shared input (copy-on-write mappings)."""
    return ReadArrays(*(shared.get(n)[s:e] for n in FIELDS))


def resident_rank(rank, shared: SharedArrays, plan: Plan, config,
                  chunk_rows: int | None):
    """One rank's share of the resident path -> (its stage timings, the
    merged CovariateTables on rank 0, else None)."""
    from ..oracle.covariate import CovariateTables
    from ..oracle.gatk import build_recal_table
    from ..pipeline.resident import (DEFAULT_CHUNK_ROWS, StageClock,
                                     apply_table_on_device,
                                     arrays_to_device)
    from .merge import COV_NAMES, broadcast_table, sum_merge

    dev = rank.device
    timings: dict = {}
    mark = StageClock(timings, dev).mark
    k = config.k
    rows = int(chunk_rows or DEFAULT_CHUNK_ROWS)
    s, e = row_range(plan.num_reads, rank.world, rank.rank)
    threshold = int(alpha_threshold(plan.alpha))
    t_host = coverage_thresholds(plan.alpha, k)
    mark("setup")

    codes, quals, mask, rgs, seconds = arrays_to_device(
        shared_rows(shared, s, e), dev)
    t_table = torch.from_numpy(t_host.astype(np.int32)).to(dev)
    mark("h2d")

    if plan.layout == "sharded":
        cov = _sharded_passes_1_to_3(rank, plan, config, codes, quals, mask,
                                     rgs, seconds, s, threshold, t_table,
                                     rows, mark, timings)
    else:
        cov = _replicated_passes_1_to_3(rank, plan, config, codes, quals,
                                        mask, rgs, seconds, s, threshold,
                                        t_table, rows, mark)
    sum_merge(rank, cov)
    tables = CovariateTables(plan.num_rg, plan.max_len,
                             *(cov[n].cpu().numpy() for n in COV_NAMES))
    mark("pass3")

    recal = broadcast_table(
        rank, build_recal_table(tables) if rank.rank == 0 else None,
        plan.num_rg, plan.max_len)
    mark("deltas")

    # ---- pass 4: the local gather into the caller's rows
    shared.write_rows("out", s, apply_table_on_device(
        recal, codes, quals, mask, rgs, seconds, rows))
    mark("pass4")
    return timings, tables if rank.rank == 0 else None


def _replicated_passes_1_to_3(rank, plan: Plan, config, codes, quals, mask,
                              rgs, seconds, s: int, threshold: int, t_table,
                              rows: int, mark) -> dict:
    """Passes 1-3 of the replicated layout on the rank's rows -> its
    covariate state (not yet summed over the ranks)."""
    from ..ops.bloom import bloom_build_words, bloom_query_words
    from ..ops.covariate import accumulate_covariates, new_covariate_state
    from ..ops.hash_cache import hash_cache_build
    from ..ops.inference import infer_errors
    from ..ops.trusted import trusted_from_cache
    from .merge import or_merge

    k, h = config.k, config.num_hashes
    n_rows = codes.shape[0]
    # ---- pass 1: hash cache of the rank's rows, merged filter A
    h1, word, flag, filt = hash_cache_build(codes, s, k, h, threshold,
                                            plan.log2_ma, chunk_rows=rows)
    filt_a = or_merge(rank, filt)
    del filt
    mark("pass1")

    # ---- pass 2: trust against the merged A, merged filter B
    trusted_from_cache(filt_a, h1, word, t_table, k, config.trust_threshold,
                       out=flag)
    del filt_a
    filt_b = or_merge(rank, bloom_build_words(h1, word, flag, plan.log2_mb))
    mark("pass2")

    # ---- pass 3: walks + histogram of the rank's rows
    cov = new_covariate_state(plan.num_rg, plan.max_len, codes.device)
    tr0 = bloom_query_words(filt_b, h1, word)
    for cs in range(0, n_rows, rows):
        ce = min(n_rows, cs + rows)
        err = infer_errors(filt_b, codes[cs:ce], k, h, config.ext_cap,
                           trusted0=tr0[cs:ce])
        accumulate_covariates(cov, codes[cs:ce], quals[cs:ce], mask[cs:ce],
                              rgs[cs:ce], seconds[cs:ce], err)
    return cov


def _sharded_passes_1_to_3(rank, plan: Plan, config, codes, quals, mask,
                           rgs, seconds, s: int, threshold: int, t_table,
                           rows: int, mark, timings: dict) -> dict:
    """Passes 1-3 of the hash-space-sharded layout on the rank's rows ->
    its covariate state (not yet summed over the ranks); the shards' word
    counts go to `timings` (``shard_words_a``, ``shard_words_b``)."""
    from ..ops.covariate import accumulate_covariates, new_covariate_state
    from ..ops.hash_cache import hash_keep
    from ..ops.trusted import trusted_from_hits
    from .sharded_bloom import ShardedFilter

    k, h = config.k, config.num_hashes
    # ---- pass 1: hash cache and keep plane, kept windows to A's owners
    h1, word, flag = hash_keep(codes, s, k, h, threshold, chunk_rows=rows)
    filt_a = ShardedFilter(rank, plan.log2_ma)
    filt_a.insert(h1, word, flag)
    timings["shard_words_a"] = int(filt_a.words.numel())
    mark("pass1")

    # ---- pass 2: collective test against A, the rule, trusted windows to
    # B's owners
    hits = filt_a.test(h1, word)
    del filt_a
    trusted_from_hits(hits, word, t_table, k, config.trust_threshold,
                      out=flag)
    del hits
    filt_b = ShardedFilter(rank, plan.log2_mb)
    filt_b.insert(h1, word, flag)
    timings["shard_words_b"] = int(filt_b.words.numel())
    mark("pass2")

    # ---- pass 3: collective initial trust, the round walk per walk block,
    # the histogram per row chunk
    cov = new_covariate_state(plan.num_rg, plan.max_len, codes.device)
    tr0 = filt_b.test(h1, word)
    del h1, word, flag
    for bs, be, err in filt_b.walk_blocks(codes, tr0, k, h, config.ext_cap):
        for cs in range(bs, be, rows):
            ce = min(be, cs + rows)
            accumulate_covariates(cov, codes[cs:ce], quals[cs:ce],
                                  mask[cs:ce], rgs[cs:ce], seconds[cs:ce],
                                  err[cs - bs:ce - bs])
    return cov


def check_batch(config, devices: int) -> None:
    """The reference's refusal (``ShardedRecalPipeline``): the batch must
    split evenly over the devices."""
    if config.batch_size % devices:
        raise ValueError(f"batch_size {config.batch_size} not divisible by "
                         f"{devices} devices")


def run_ranks(body, arrays: ReadArrays, devices: int, device_type: str,
              timings: dict | None, *args) -> np.ndarray:
    """Share `arrays`, run ``body(rank, shared, *args)`` on `devices` ranks
    (it returns (its timings, tables or None)), and return the output rows;
    the slowest rank's stages, each rank's own (``by_rank``), the launch's
    own figures and ``share`` (s to write the shared files) go to
    `timings`, rank 0's tables to ``oracle.gatk``'s capture
    (report_out)."""
    from ..oracle.gatk import note_tables
    t0 = time.time()
    shared = share_arrays(arrays)
    t_share = time.time() - t0
    try:
        run_t: dict = {}
        res = launch(body, devices, device_type, shared, *args,
                     timings=run_t)
        out = np.asarray(shared.get("out"))
    finally:
        shared.close()
    if res[0][1] is not None:
        note_tables(res[0][1])
    if timings is not None:
        timings["share"] = round(t_share, 3)
        slowest([r[0] for r in res], timings)
        timings.update(run_t)
        timings["by_rank"] = [r[0] for r in res]
    return out


def recalibrate_arrays_resident_sharded(arrays: ReadArrays, config,
                                        devices: int, device=None,
                                        timings: dict | None = None,
                                        chunk_rows: int | None = None
                                        ) -> np.ndarray:
    """Full pipeline over in-memory arrays on `devices` ranks, the
    replicated layout -> new quals int8 [N, L], the bytes of one device.

    Each rank is a process on its own card (NCCL), or on the CPU for
    device="cpu" (gloo); device=None means the cards and raises without
    one.  `timings` gets the slowest rank's stages (setup, h2d, pass1-4,
    deltas; with ``*_peak_bytes`` on cards), ``spawn``, ``merge`` and
    ``merge_bytes``, ``world``, ``backend`` and ``launches_by_rank``.
    """
    from .. import resolve_device
    dev = resolve_device(device)
    check_batch(config, devices)
    if arrays.num_reads == 0:
        return np.zeros((0, arrays.max_len), np.int8)
    plan = plan_for(arrays, config)
    return run_ranks(resident_rank, arrays, devices, dev.type, timings, plan,
                     config, chunk_rows)

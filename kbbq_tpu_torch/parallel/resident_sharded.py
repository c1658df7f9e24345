"""The resident path over the ranks of a group (replicated filters).

Counterpart of ``kbbq_tpu/parallel/resident_sharded.py::
recalibrate_arrays_resident_sharded``: ``pipeline/resident.py``'s four
passes, each rank on its contiguous share of the rows, every rank holding
whole filters (the replicated layout):

  pass 1  hash cache of the rank's rows with ``first_id`` = the global
          ordinal of its first row (sampling keys on it, DECISIONS D5),
          then filter A = ``or_merge`` of the ranks' filters
  pass 2  trust against the merged A, the local build of B, ``or_merge``
  pass 3  initial trust, walks and histogram on the rank's rows, then
          ``sum_merge`` of the tables
  deltas  on rank 0, the Q' table broadcast
  pass 4  the local gather, written into the caller's rows

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


def plan_for(arrays: ReadArrays, config) -> Plan:
    """The ``Plan`` of `arrays` under `config`; refuses filters the
    replicated layout cannot hold (``check_layout_capacity``)."""
    k = config.k
    lens = arrays.mask.sum(axis=1)
    total_bases = int(lens.sum())
    total_kmers = int(np.maximum(lens - k + 1, 0).sum())
    alpha, coverage = config.resolve_alpha(total_bases)
    pa, pb = bloom_params_for(config, total_kmers, alpha, coverage)
    for p in (pa, pb):
        # every rank holds both filters whole, as packed words
        check_layout_capacity(p, 33, "replicated resident",
                              "use --bloom-layout sharded")
    return Plan(arrays.num_reads, arrays.max_len,
                int(arrays.rgs.max(initial=0)) + 1, total_bases, total_kmers,
                alpha, pa.log2_m, pb.log2_m)


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
    from ..ops.bloom import bloom_build_words, bloom_query_words
    from ..ops.covariate import accumulate_covariates, new_covariate_state
    from ..ops.hash_cache import hash_cache_build
    from ..ops.inference import infer_errors
    from ..ops.trusted import trusted_from_cache
    from ..oracle.covariate import CovariateTables
    from ..oracle.gatk import build_recal_table
    from ..pipeline.resident import (DEFAULT_CHUNK_ROWS, StageClock,
                                     apply_table_on_device,
                                     arrays_to_device)
    from .merge import COV_NAMES, broadcast_table, or_merge, sum_merge

    dev = rank.device
    timings: dict = {}
    mark = StageClock(timings, dev).mark
    k, h = config.k, config.num_hashes
    rows = int(chunk_rows or DEFAULT_CHUNK_ROWS)
    s, e = row_range(plan.num_reads, rank.world, rank.rank)
    threshold = int(alpha_threshold(plan.alpha))
    t_host = coverage_thresholds(plan.alpha, k)
    mark("setup")

    codes, quals, mask, rgs, seconds = arrays_to_device(
        shared_rows(shared, s, e), dev)
    t_table = torch.from_numpy(t_host.astype(np.int32)).to(dev)
    mark("h2d")

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

    # ---- pass 3: walks + histogram of the rank's rows, summed tables
    cov = new_covariate_state(plan.num_rg, plan.max_len, dev)
    tr0 = bloom_query_words(filt_b, h1, word)
    for cs in range(0, e - s, rows):
        ce = min(e - s, cs + rows)
        err = infer_errors(filt_b, codes[cs:ce], k, h, config.ext_cap,
                           trusted0=tr0[cs:ce])
        accumulate_covariates(cov, codes[cs:ce], quals[cs:ce], mask[cs:ce],
                              rgs[cs:ce], seconds[cs:ce], err)
    del tr0, h1, word, flag, filt_b
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
    the slowest rank's stages, the launch's own figures and ``share`` (s to
    write the shared files) go to `timings`, rank 0's tables to
    ``oracle.gatk``'s capture (report_out)."""
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

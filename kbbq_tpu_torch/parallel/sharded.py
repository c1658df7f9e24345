"""The windowed engine over the ranks of a group, and the dispatch of the
multi-device routes with either Bloom layout.

Counterpart of ``kbbq_tpu/parallel/sharded.py`` (``ShardedRecalPipeline``,
``sharded_recalibrate_arrays``), of
``kbbq_tpu/parallel/sharded_bloom.py::sharded_bloom_recalibrate_arrays``
and of the multi-device branches of
``kbbq_tpu/pipeline/streaming.py::recalibrate_fastq_streaming`` and
``kbbq_tpu/pipeline/bam.py::recalibrate_bam_streaming``.  Each rank runs
``pipeline/stream_resident.py``'s engine on windows w with w mod D = its
rank, at their global ordinals; the tables merge by ``sum_merge``.  With
the replicated layout the filters merge by ``or_merge`` at every pass
boundary; with the hash-space-sharded one (``sharded_bloom.py``) each rank
holds its shard of each filter and the passes exchange with the owners.
Rank 0 writes the checkpoints, in the one-device files (the fingerprint
holds no device count, so a checkpoint written by D ranks resumes on any
count; a sharded filter's shards reach its host one at a time), and the
report.  Pass 4: over in-memory arrays every rank writes its windows' rows
into the caller's output; on the streamed routes rank 0's writer takes
every window in order, the other ranks' rows sent to it.

The caller's process scans the input, checks the checkpoint's fingerprint
and the layout before any rank starts, so those refusals cost no start-up.
A writable sink (standard output) is written by rank 0 into a temporary
file that the caller copies into it.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from .mesh import check_devices, launch, slowest
from .sharded_bloom import check_power_of_two
from .resident_sharded import (Plan, check_batch, plan_for, resident_rank,
                               run_ranks, shared_rows)

# filters' bits on each rank at most for the replicated layout under
# bloom_layout="auto" (the JAX package's REPLICATED_BLOOM_BUDGET)
REPLICATED_BLOOM_BUDGET = 4 << 30


def resolve_layout(bloom_layout: str, config, total_bases: int,
                   total_kmers: int, devices: int | None = None) -> str:
    """'replicated' or 'sharded': "auto" picks the replicated layout while
    both filters together hold at most REPLICATED_BLOOM_BUDGET bits (the
    reference's rule), else the hash-space-sharded one, which is refused
    for a device count that is not a power of two (`devices`)."""
    if bloom_layout == "auto":
        from ..oracle.pipeline import bloom_params_for
        alpha, coverage = config.resolve_alpha(int(total_bases))
        pa, pb = bloom_params_for(config, int(total_kmers), alpha, coverage)
        bloom_layout = ("replicated"
                        if pa.m + pb.m <= REPLICATED_BLOOM_BUDGET
                        else "sharded")
    if bloom_layout not in ("replicated", "sharded"):
        raise ValueError(f"unknown bloom layout {bloom_layout!r}")
    if bloom_layout == "sharded" and devices is not None:
        check_power_of_two(devices)
    return bloom_layout


def windowed_rank(rank, shared, config, start_ordinal: int, checkpoint_dir,
                  chunk_rows, window_rows: int, layout: str = "replicated"):
    """One rank's windows of the in-memory arrays -> (its stage timings, the
    tables on rank 0, else None); each window's rows go into the
    caller's output.  The sharded layout's filters are checkpointed as
    ``rows_a_sharded`` / ``rows_b_sharded`` (the reference's names on this
    route)."""
    from ..pipeline.stream_resident import (ArraysWindowSource,
                                            StreamResidentEngine)
    from ..state.checkpoint import Checkpoint
    from ..utils.trace import tracer

    timings: dict = {}
    with tracer(timings, rank.device) as trace:
        trace.stage("setup")
        arrays = shared_rows(shared, 0, None)
        ckpt = Checkpoint(checkpoint_dir) if checkpoint_dir else None
        src = ArraysWindowSource(arrays, window_rows, start_ordinal)
        names = ("rows_a_sharded", "rows_b_sharded") \
            if layout == "sharded" else ("rows_a", "rows_b")
        eng = StreamResidentEngine(src, config, rank.device,
                                   chunk_rows=chunk_rows, rank=rank,
                                   layout=layout, filter_names=names,
                                   trace=trace)
        recal = eng.run_passes_1_to_3(ckpt)
        trace.stage("pass4")
        for ordinal, nq, _ in eng.gathered(recal):
            shared.write_rows("out", ordinal - start_ordinal, nq)
    return timings, eng.tables if rank.rank == 0 else None


def arrays_rank(rank, shared, plan: Plan, config, chunk_rows):
    """The resident path when every rank's share fits its card (its rows
    and both filters, or their shards, ``resident_need_bytes``), else the
    windowed engine; the ranks agree by an all-reduce of the answer."""
    import torch
    import torch.distributed as dist

    from ..pipeline.recalibrate import resident_need_bytes
    from ..pipeline.stream_resident import DEFAULT_CHUNK_READS
    fits = 1
    if rank.device.type == "cuda":
        need = resident_need_bytes(
            -(-plan.num_reads // rank.world), plan.max_len, plan.total_bases,
            plan.total_kmers, config, chunk_rows,
            shards=rank.world if plan.layout == "sharded" else None)
        fits = int(need <= torch.cuda.mem_get_info(rank.device)[0])
    flag = torch.tensor([fits], dtype=torch.int32, device=rank.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    if int(flag.item()):
        return resident_rank(rank, shared, plan, config, chunk_rows)
    return windowed_rank(rank, shared, config, 0, None, chunk_rows,
                         max(int(config.batch_size), DEFAULT_CHUNK_READS),
                         plan.layout)


def run_arrays_sharded(arrays, config, devices: int, device_type: str,
                       timings: dict | None = None,
                       chunk_rows: int | None = None,
                       layout: str = "replicated") -> np.ndarray:
    """``run_pipeline``'s route over `devices` ranks with nothing to resume
    (no checkpoint, first ordinal 0): the resident path, or the windowed
    engine where a rank's share is over its card's free memory; `layout`
    "replicated" or "sharded" (``resolve_layout``'s answer).  With the
    sharded layout `timings` also gets ``shard_words_a`` / ``_b``, the words
    of each filter a rank held (resident path)."""
    if arrays.num_reads == 0:
        return np.zeros((0, arrays.max_len), np.int8)
    plan = plan_for(arrays, config, layout, devices)
    return run_ranks(arrays_rank, arrays, devices, device_type, timings,
                     plan, config, chunk_rows)


def sharded_recalibrate_arrays(arrays, config, devices: int,
                               start_ordinal: int = 0,
                               checkpoint_dir: str | None = None,
                               device=None, timings: dict | None = None,
                               chunk_rows: int | None = None,
                               window_rows: int | None = None,
                               layout: str = "replicated") -> np.ndarray:
    """Full pipeline over in-memory arrays through the windowed engine on
    `devices` ranks -> new quals int8 [N, L], the bytes of one device (of
    the reference's sharded pipeline with `layout` "sharded", which bumps
    the filters of a small input).

    Windows of `window_rows` rows (default ``max(config.batch_size,
    DEFAULT_CHUNK_READS)``, as on one device; the result does not depend
    on it); row r samples as global ordinal start_ordinal + r.  With
    checkpoint_dir, passes 1-3 are saved at their boundaries under
    ``run_fingerprint`` (the one-device checkpoint: it resumes on any
    number of ranks).  device and `timings` as in
    ``recalibrate_arrays_resident_sharded``.
    """
    from .. import resolve_device
    from ..pipeline.stream_resident import DEFAULT_CHUNK_READS
    dev = resolve_device(device)
    check_batch(config, devices)
    if arrays.num_reads == 0:
        return np.zeros((0, arrays.max_len), np.int8)
    plan_for(arrays, config, layout, devices)
    if checkpoint_dir:
        from ..state.checkpoint import Checkpoint, run_fingerprint
        Checkpoint(checkpoint_dir).check_fingerprint(
            run_fingerprint(config, arrays))
    rows = int(window_rows or max(int(config.batch_size),
                                  DEFAULT_CHUNK_READS))
    return run_ranks(windowed_rank, arrays, devices, dev.type, timings,
                     config, int(start_ordinal), checkpoint_dir, chunk_rows,
                     rows, layout)


class _Relay:
    """Writable sinks (standard output, a file object) of a streamed route
    stand in as temporary files for rank 0; ``finish`` copies each into
    its sink."""

    def __init__(self, out_paths):
        self.dir = None
        self.pairs: list = []
        if isinstance(out_paths, (list, tuple)):
            self.paths = [self._one(o) for o in out_paths]
        else:
            self.paths = self._one(out_paths)

    def _one(self, o):
        if isinstance(o, (str, bytes)):
            return o
        if self.dir is None:
            self.dir = tempfile.mkdtemp(prefix="kbbq_sink_")
        path = os.path.join(self.dir, f"sink{len(self.pairs)}")
        self.pairs.append((path, o))
        return path

    def finish(self) -> None:
        for path, sink in self.pairs:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    shutil.copyfileobj(f, sink, 16 << 20)

    def close(self) -> None:
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)


def _rank_of_run(rank, run, kw: dict):
    """One rank of a streamed route: ``run(**kw)`` (``fastq_windowed_run``
    or ``bam_windowed_run``) with the rank's device and its own tracer
    -> (timings, stats)."""
    from ..utils.trace import tracer
    timings: dict = {}
    with tracer(timings, rank.device) as trace:
        trace.stage("setup")
        stats = run(trace=trace, dev=rank.device, rank=rank, **kw)
    return timings, stats


def _run_streamed(run, kw: dict, relay: _Relay, devices: int,
                  device_type: str, timings: dict | None) -> dict:
    """Launch `run` on the ranks and copy the relayed sinks; the slowest
    rank's stages and the launch's figures into `timings`; rank 0's
    stats."""
    run_t: dict = {}
    try:
        res = launch(_rank_of_run, devices, device_type, run, kw,
                     timings=run_t)
        relay.finish()
    finally:
        relay.close()
    if timings is not None:
        slowest([r[0] for r in res], timings)
        timings.update(run_t)
    return res[0][1]


def recalibrate_fastq_sharded(in_paths, out_paths, config, devices: int,
                              checkpoint_dir=None, interleaved=False,
                              chunk_reads=None, timings=None,
                              report_out=None, apply_report=None,
                              device=None, host_cache_bytes=None,
                              device_cache_bytes=None,
                              bloom_layout: str = "auto") -> dict:
    """``recalibrate_fastq_streaming`` on `devices` ranks: the caller scans
    the files and checks the fingerprint and the layout, every rank runs
    the windowed engine on its windows, rank 0 writes the output (the
    bytes of one device), the report and the checkpoints.  Arguments as
    ``pipeline.stream_resident.recalibrate_fastq_stream_resident``;
    `timings` also gets the caller's ``scan`` stage, ``spawn``,
    ``merge``, ``merge_bytes``, ``world``, ``backend`` and
    ``launches_by_rank``."""
    from .. import resolve_device
    from ..io.stream import DEFAULT_CHUNK_READS, scan_fastq_files
    from ..pipeline.stream_resident import (DEFAULT_HOST_CACHE_BYTES,
                                            check_fastq_checkpoint,
                                            fastq_windowed_run)
    from ..utils.trace import tracer
    dev = resolve_device(device)
    check_devices(devices, dev.type)
    check_batch(config, devices)
    if isinstance(in_paths, (str, bytes)):
        in_paths = [in_paths]
    chunk_reads = int(chunk_reads or DEFAULT_CHUNK_READS)
    with tracer(timings, dev) as trace:
        trace.stage("scan")
        scan = scan_fastq_files(in_paths, config.k, chunk_reads)
        trace.stage(None)
    layout = resolve_layout(bloom_layout, config, scan.total_bases,
                            scan.total_kmers(config.k), devices)
    check_fastq_checkpoint(checkpoint_dir, config, in_paths, scan,
                           chunk_reads, interleaved)
    relay = _Relay(out_paths)
    kw = dict(in_paths=list(in_paths), out_paths=relay.paths, config=config,
              scan=scan, checkpoint_dir=checkpoint_dir,
              interleaved=bool(interleaved), chunk_reads=chunk_reads,
              report_out=report_out, apply_report=apply_report,
              host_cache_bytes=DEFAULT_HOST_CACHE_BYTES
              if host_cache_bytes is None else host_cache_bytes,
              device_cache_bytes=device_cache_bytes, layout=layout)
    return _run_streamed(fastq_windowed_run, kw, relay, devices, dev.type,
                         timings)


def recalibrate_bam_sharded(in_path: str, out_path, config, devices: int,
                            use_oq=False, set_oq=False, checkpoint_dir=None,
                            chunk_records=None, timings=None,
                            report_out=None, apply_report=None, device=None,
                            host_cache_bytes=None, device_cache_bytes=None,
                            bloom_layout: str = "auto") -> dict:
    """``recalibrate_bam_streaming`` on `devices` ranks, as
    ``recalibrate_fastq_sharded`` for FASTQ: the caller scans the BAM,
    every rank runs its windows, rank 0 writes the output (the bytes of one
    device)."""
    from .. import resolve_device
    from ..io.bam_stream import DEFAULT_CHUNK_RECORDS
    from ..pipeline.bam import scan_bam
    from ..pipeline.stream_resident import (DEFAULT_HOST_CACHE_BYTES,
                                            bam_windowed_run,
                                            check_bam_checkpoint)
    from ..utils.trace import tracer
    dev = resolve_device(device)
    check_devices(devices, dev.type)
    check_batch(config, devices)
    chunk_records = int(chunk_records or DEFAULT_CHUNK_RECORDS)
    with tracer(timings, dev) as trace:
        trace.stage("scan")
        scan = scan_bam(in_path, config.k, chunk_records)
        trace.stage(None)
    layout = resolve_layout(bloom_layout, config, scan[1], scan[2], devices)
    check_bam_checkpoint(checkpoint_dir, config, scan, use_oq)
    relay = _Relay(out_path)
    kw = dict(in_path=in_path, out_path=relay.paths, config=config,
              scan=scan, use_oq=bool(use_oq), set_oq=bool(set_oq),
              checkpoint_dir=checkpoint_dir, chunk_records=chunk_records,
              report_out=report_out, apply_report=apply_report,
              host_cache_bytes=DEFAULT_HOST_CACHE_BYTES
              if host_cache_bytes is None else host_cache_bytes,
              device_cache_bytes=device_cache_bytes, layout=layout)
    return _run_streamed(bam_windowed_run, kw, relay, devices, dev.type,
                         timings)


__all__ = ["REPLICATED_BLOOM_BUDGET", "recalibrate_bam_sharded",
           "recalibrate_fastq_sharded", "resolve_layout",
           "run_arrays_sharded", "sharded_recalibrate_arrays"]

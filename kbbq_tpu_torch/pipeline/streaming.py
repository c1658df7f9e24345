"""Streamed FASTQ -> FASTQ recalibration with bounded host memory.

Counterpart of ``kbbq_tpu/pipeline/streaming.py::
recalibrate_fastq_streaming``: the input is read from disk chunk by chunk,
through the windowed engine of ``pipeline/stream_resident.py``, with
pass-boundary checkpoints and pass-4 chunk-offset resume.  On one device it
IS the engine's FASTQ entry point; with ``devices`` > 1 the engine runs on
every rank of a process group (``parallel/sharded.py::
recalibrate_fastq_sharded``) and writes the same bytes.
"""

from __future__ import annotations

from ..io.stream import DEFAULT_CHUNK_READS
from .stream_resident import (DEFAULT_HOST_CACHE_BYTES,
                              recalibrate_fastq_stream_resident)


def recalibrate_fastq_streaming(
        in_paths, out_paths, config, checkpoint_dir: str | None = None,
        interleaved: bool = False, chunk_reads: int = DEFAULT_CHUNK_READS,
        timings: dict | None = None, report_out: str | None = None,
        apply_report: str | None = None, device=None,
        host_cache_bytes: int = DEFAULT_HOST_CACHE_BYTES,
        device_cache_bytes: int | None = None, devices: int | None = None,
        bloom_layout: str = "auto") -> dict:
    """FASTQ -> FASTQ recalibration with host memory O(window); arguments
    as ``stream_resident.recalibrate_fastq_stream_resident``.

    devices: None or 1 is one device; N > 1 runs N ranks (one per card, or
    CPU processes for device="cpu"), with the filters' ``bloom_layout`` and
    the refusals of ``run_pipeline`` (too many devices, a batch size N does
    not divide, the sharded layout on N not a power of two; checkpoints
    keep the one-device names).  `timings` then also gets
    ``spawn``, ``merge``, ``merge_bytes``, ``exchange``,
    ``exchange_bytes``, ``world``, ``backend`` and ``launches_by_rank``,
    and the slowest rank's stages.
    """
    if devices is not None and devices > 1:
        from ..parallel.sharded import recalibrate_fastq_sharded
        return recalibrate_fastq_sharded(
            in_paths, out_paths, config, devices,
            checkpoint_dir=checkpoint_dir, interleaved=interleaved,
            chunk_reads=chunk_reads, timings=timings, report_out=report_out,
            apply_report=apply_report, device=device,
            host_cache_bytes=host_cache_bytes,
            device_cache_bytes=device_cache_bytes,
            bloom_layout=bloom_layout)
    return recalibrate_fastq_stream_resident(
        in_paths, out_paths, config, checkpoint_dir=checkpoint_dir,
        interleaved=interleaved, chunk_reads=chunk_reads, timings=timings,
        report_out=report_out, apply_report=apply_report, device=device,
        host_cache_bytes=host_cache_bytes,
        device_cache_bytes=device_cache_bytes)


__all__ = ["recalibrate_fastq_streaming"]

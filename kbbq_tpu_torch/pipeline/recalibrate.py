"""End-to-end recalibration entry points of the port (single device).

Counterpart of ``kbbq_tpu/pipeline/recalibrate.py``: ``RecalConfig``,
``run_pipeline``, the pass-4-only ``apply_table_arrays`` and the FASTQ ->
FASTQ entry point ``recalibrate_fastq`` with its GATKReport and checkpoint
options.  ``run_pipeline`` takes the resident path when the data fits the
card and nothing asks for the windowed engine (a checkpoint directory, a
first ordinal other than 0).  Bit-exact parity authority: the NumPy oracle
of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import (
    DEFAULT_K,
    DEFAULT_NUM_HASHES,
    DEFAULT_SAMPLED_BITS_PER_KEY,
    DEFAULT_TRUSTED_BITS_PER_KEY,
    LIGHTER_ALPHA_NUMERATOR,
)
from ..io.batcher import ReadArrays


@dataclasses.dataclass
class RecalConfig:
    """The JAX package's RecalConfig without ``walk_chunk`` and
    ``use_pallas``: the port's walk is one kernel launch with no chunk
    width, and its kernels are the only device path."""

    k: int = DEFAULT_K
    alpha: float | None = None
    coverage: float | None = None
    genome_length: int | None = None
    num_hashes: int = DEFAULT_NUM_HASHES
    sampled_bits_per_key: int = DEFAULT_SAMPLED_BITS_PER_KEY
    trusted_bits_per_key: int = DEFAULT_TRUSTED_BITS_PER_KEY
    trust_threshold: int | None = None
    ext_cap: int | None = None   # None -> DEFAULT_EXT_CAP (D7)
    # floor on both filters' log2_m; bit-exact-spec relevant: filter size
    # changes FP sets, so every pipeline compared must set it identically
    min_log2_m: int | None = None
    # rows per window of the windowed engine over in-memory arrays, at least
    # DEFAULT_CHUNK_READS (io/stream.py); the resident path cuts the dataset
    # by its own `chunk_rows` and does not read it (the result depends on
    # neither)
    batch_size: int = 512

    def resolve_alpha(self, total_bases: int) -> tuple[float, float]:
        cov = self.coverage
        if cov is None and self.genome_length:
            cov = total_bases / self.genome_length
        if cov is None:
            cov = 30.0
        alpha = self.alpha
        if alpha is None:
            alpha = min(1.0, LIGHTER_ALPHA_NUMERATOR / max(cov, 1.0))
        return alpha, cov


# device bytes the resident path holds at its peak, per padded base: pass 3
# of 1,533,333 x 150 bases peaked at 3,327,267,328 B on an NVIDIA H100 80GB
# HBM3 (chip_smoke.py, PERF.md)
RESIDENT_BYTES_PER_BASE = 14.47


def fits_resident(arrays: ReadArrays, dev) -> bool:
    """Whether the resident path's peak fits the card's free memory (always
    on the CPU)."""
    if dev.type != "cuda":
        return True
    need = arrays.num_reads * arrays.max_len * RESIDENT_BYTES_PER_BASE
    return need <= torch.cuda.mem_get_info(dev)[0]


def run_pipeline(arrays: ReadArrays, config: RecalConfig,
                 device=None, timings: dict | None = None,
                 chunk_rows: int | None = None,
                 checkpoint_dir: str | None = None,
                 start_ordinal: int = 0) -> np.ndarray:
    """Recalibrate in-memory arrays on one device -> new quals int8 [N, L].

    The resident path, unless checkpoint_dir is set (pass-boundary saves,
    resume), start_ordinal is not 0 (row r samples as ordinal
    start_ordinal + r), or the data does not fit the card: then the
    windowed engine (``stream_resident.recalibrate_arrays_windowed``),
    which gives the same bytes.  device=None means the CUDA device and
    raises without one; pass device="cpu" to run on the CPU.
    """
    from .. import resolve_device
    dev = resolve_device(device)
    if arrays.num_reads == 0:
        return np.zeros((0, arrays.max_len), np.int8)
    if checkpoint_dir is None and start_ordinal == 0 and \
            fits_resident(arrays, dev):
        from .resident import recalibrate_arrays_resident
        return recalibrate_arrays_resident(arrays, config, timings=timings,
                                           device=dev, chunk_rows=chunk_rows)
    from .stream_resident import recalibrate_arrays_windowed
    return recalibrate_arrays_windowed(
        arrays, config, start_ordinal=start_ordinal,
        checkpoint_dir=checkpoint_dir, device=dev, timings=timings,
        chunk_rows=chunk_rows)


def apply_table_arrays(arrays: ReadArrays, recal_table: np.ndarray,
                       device=None, chunk_rows: int | None = None
                       ) -> np.ndarray:
    """Pass 4 ONLY: apply an externally supplied Q' table (the
    ApplyBQSR-equivalent path) -> new quals int8 [N, L].  The same gather,
    by the same row chunks, that the full pipeline's pass 4 runs, so a
    table rebuilt from a report reproduces the direct run.  No kernel is
    launched.  device=None means the CUDA device (raises without one)."""
    from .. import resolve_device
    from .resident import (DEFAULT_CHUNK_ROWS, apply_table_on_device,
                           arrays_to_device)
    dev = resolve_device(device)
    if arrays.num_reads == 0:
        return np.zeros((0, arrays.max_len), np.int8)
    return apply_table_on_device(
        np.ascontiguousarray(recal_table), *arrays_to_device(arrays, dev),
        int(chunk_rows or DEFAULT_CHUNK_ROWS))


def _run_or_apply(arrays, config, rg_names, report_out, apply_report,
                  **run_kwargs):
    """Engine dispatch of the report-aware entry points: apply_report -> pass 4
    only, from a parsed GATKReport; report_out -> the full pipeline, and
    the report of its covariate tables; else the plain pipeline."""
    if apply_report is not None:
        from ..gatk_report import read_gatk_report, recal_table_from_report
        table = recal_table_from_report(
            read_gatk_report(apply_report), rg_names, arrays.max_len)
        return apply_table_arrays(arrays, table,
                                  device=run_kwargs.get("device"))
    if report_out is not None:
        from ..gatk_report import write_gatk_report
        from ..oracle.gatk import captured_tables
        with captured_tables() as cap:
            new_quals = run_pipeline(arrays, config, **run_kwargs)
        write_gatk_report(cap["tables"], rg_names, report_out)
        return new_quals
    return run_pipeline(arrays, config, **run_kwargs)


def _load_fastq_arrays(in_paths, interleaved: bool):
    """Load FASTQ inputs into one padded ReadArrays (each input file is
    its own read group, DECISIONS.md D8): (fqs, mask_list, arrays)."""
    from ..io.fastq import extract_padded_arrays, read_fastq

    fqs = [read_fastq(p) for p in in_paths]
    parts = [extract_padded_arrays(fq) for fq in fqs]
    max_len = max((p[0].shape[1] for p in parts if p[0].shape[0]),
                  default=1)
    codes_l, quals_l, mask_l, rg_l, sec_l = [], [], [], [], []
    for rg, (fq, (codes, quals, mask, lens)) in enumerate(zip(fqs, parts)):
        pad = max_len - codes.shape[1]
        if pad:
            codes = np.pad(codes, ((0, 0), (0, pad)), constant_values=4)
            quals = np.pad(quals, ((0, 0), (0, pad)))
            mask = np.pad(mask, ((0, 0), (0, pad)))
        codes_l.append(codes)
        quals_l.append(quals)
        mask_l.append(mask)
        rg_l.append(np.full(fq.num_reads, rg, np.int32))
        if interleaved:
            # D11: interleaved pairing — odd ordinals are second-in-pair
            sec_l.append(np.arange(fq.num_reads) % 2 == 1)
        else:
            sec_l.append(fq.seconds_mask())
    if len(fqs) == 1:
        arrays = ReadArrays(codes_l[0], quals_l[0], mask_l[0], rg_l[0],
                            sec_l[0])
    else:
        arrays = ReadArrays(np.concatenate(codes_l), np.concatenate(quals_l),
                            np.concatenate(mask_l), np.concatenate(rg_l),
                            np.concatenate(sec_l))
    return fqs, mask_l, arrays


def _write_fastq_outputs(fqs, mask_l, new_quals, out_paths) -> None:
    """Route per-input qual rows to out_paths (matching list, one
    concatenated sink path, or a writable)."""
    from ..io.fastq import open_fastq_sink, write_fastq_with_quals

    # A single path (or file object) with multiple inputs is ONE
    # concatenated sink: open it once so later inputs append rather than
    # truncate.
    opened = None
    if isinstance(out_paths, (str, bytes)) and len(fqs) > 1:
        opened = open_fastq_sink(out_paths)
        out_paths = [opened] * len(fqs)
    elif isinstance(out_paths, (str, bytes)) or not isinstance(
            out_paths, (list, tuple)):
        out_paths = [out_paths] * len(fqs)
    if len(out_paths) != len(fqs):
        raise ValueError("need one output per input (or a single sink)")
    try:
        s = 0
        for fq, mask, out in zip(fqs, mask_l, out_paths):
            e = s + fq.num_reads
            write_fastq_with_quals(fq, new_quals[s:e], mask[:fq.num_reads],
                                   out)
            s = e
    finally:
        if opened is not None:
            opened.close()


def recalibrate_fastq(in_paths, out_paths, config: RecalConfig,
                      interleaved: bool = False, device=None,
                      timings: dict | None = None,
                      report_out: str | None = None,
                      apply_report: str | None = None,
                      checkpoint_dir: str | None = None) -> dict:
    """FASTQ -> FASTQ recalibration (the reference CLI's main flow), with
    the whole input in host memory (``recalibrate_fastq_streaming`` reads
    it chunk by chunk).

    Accepts one path or a list; each input file is its own read group
    (DECISIONS.md D8).  out_paths: matching list, a single path, or a
    writable (outputs concatenated in input order).  Plain or gzip input,
    plain or BGZF (``.gz``) output.  device=None means the CUDA device
    (raises without one).  `timings`, when given, also gets ``read`` and
    ``write`` (host IO, s).

    report_out: also write the computed covariates as a GATKReport.
    apply_report: SKIP passes 1-3 and recalibrate from a previously
    written report instead (ApplyBQSR-equivalent; read groups match by
    input path, so pass the same inputs in the same order).
    checkpoint_dir: save passes 1-3 at their boundaries and resume from
    the first one not saved (``run_pipeline``).
    """
    import time

    from .. import resolve_device
    dev = resolve_device(device)
    if isinstance(in_paths, (str, bytes)):
        in_paths = [in_paths]
    t0 = time.time()
    fqs, mask_l, arrays = _load_fastq_arrays(in_paths, interleaved)
    t1 = time.time()
    new_quals = _run_or_apply(arrays, config, [str(p) for p in in_paths],
                              report_out, apply_report, device=dev,
                              timings=timings, checkpoint_dir=checkpoint_dir)
    t2 = time.time()
    _write_fastq_outputs(fqs, mask_l, new_quals, out_paths)
    if timings is not None:
        timings["read"] = round(t1 - t0, 3)
        timings["write"] = round(time.time() - t2, 3)
    return {"num_reads": arrays.num_reads,
            "total_bases": int(arrays.mask.sum()),
            "read_groups": len(fqs)}

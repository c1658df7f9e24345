"""End-to-end recalibration entry points of the port.

Counterpart of ``kbbq_tpu/pipeline/recalibrate.py``: ``RecalConfig``,
``run_pipeline``, the pass-4-only ``apply_table_arrays`` and the FASTQ ->
FASTQ entry point ``recalibrate_fastq`` with its GATKReport and checkpoint
options.  ``run_pipeline`` takes the resident path when the data fits the
card and nothing asks for the windowed engine (a checkpoint directory, a
first ordinal other than 0); with ``devices`` > 1 it runs a process per
device (``parallel/``).  Bit-exact parity authority: the NumPy oracle of
the JAX package.
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
from ..utils.trace import OFF, tracer


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


# device bytes per (chunk row x padded base) of pass 3's per-chunk
# temporaries (the walk's marks, the histogram's int64 index planes): the
# resident peak of 1,533,333 x 150 bases at k = 32, 3,327,267,328 B on an
# NVIDIA H100 80GB HBM3 (chip_smoke.py, PERF.md), less the shape terms of
# resident_need_bytes, over 65,536 x 150 cells, rounded up
CHUNK_BYTES_PER_CELL = 78


def resident_need_bytes(num_reads: int, max_len: int, total_bases: int,
                        total_kmers: int, config: RecalConfig,
                        chunk_rows: int | None = None,
                        shards: int | None = None) -> int:
    """Device bytes the resident path needs at its peak for `num_reads`
    reads padded to `max_len` (holding `total_bases` bases and
    `total_kmers` k-mers) under `config`, from the shapes: codes, quals and
    mask (1 B each per padded base); rgs and seconds (9 B a read); per
    window of the [N, max_len - k + 1] hash cache its h1 and word (4 B
    each), the keep / trust plane and pass 3's initial trust (1 B each);
    filters A and B (m / 8 bytes each); and pass 3's per-chunk temporaries
    (CHUNK_BYTES_PER_CELL per chunk row and padded base).  With `shards`
    (the hash-space-sharded layout on that many ranks) each filter counts
    at its shard, 1/shards of its bumped size, and one chunk of the
    filters' exchange and the walk state of one walk block
    (``walk_block_bytes`` of min(N, WALK_BLOCK_ROWS) rows) are added."""
    from ..oracle.pipeline import bloom_params_for
    from .resident import DEFAULT_CHUNK_ROWS
    N, L = int(num_reads), int(max_len)
    alpha, coverage = config.resolve_alpha(int(total_bases))
    if shards:
        from ..parallel.sharded_bloom import (EXCHANGE_BYTES_PER_ENTRY,
                                              EXCHANGE_CHUNK, WALK_BLOCK_ROWS,
                                              sharded_params,
                                              walk_block_bytes)
        pa, pb = sharded_params(config, int(total_kmers), alpha, coverage,
                                shards)
        extra = (EXCHANGE_CHUNK * EXCHANGE_BYTES_PER_ENTRY
                 + walk_block_bytes(min(N, WALK_BLOCK_ROWS), L, config.k))
    else:
        pa, pb = bloom_params_for(config, int(total_kmers), alpha, coverage)
        shards, extra = 1, 0
    windows = N * max(L - config.k + 1, 0)
    rows = min(N, int(chunk_rows or DEFAULT_CHUNK_ROWS))
    return (3 * N * L + 9 * N + 10 * windows
            + ((1 << pa.log2_m) + (1 << pb.log2_m)) // 8 // shards
            + CHUNK_BYTES_PER_CELL * rows * L + extra)


def fits_resident(arrays: ReadArrays, dev, config: RecalConfig,
                  chunk_rows: int | None = None) -> bool:
    """Whether the resident path's peak (``resident_need_bytes``) fits the
    card's free memory (always on the CPU)."""
    if dev.type != "cuda":
        return True
    lens = arrays.read_lengths()
    need = resident_need_bytes(
        arrays.num_reads, arrays.max_len, int(lens.sum()),
        int(np.maximum(lens - config.k + 1, 0).sum()), config, chunk_rows)
    return need <= torch.cuda.mem_get_info(dev)[0]


def run_pipeline(arrays: ReadArrays, config: RecalConfig,
                 device=None, timings: dict | None = None,
                 chunk_rows: int | None = None,
                 checkpoint_dir: str | None = None,
                 start_ordinal: int = 0, devices: int | None = None,
                 bloom_layout: str = "auto") -> np.ndarray:
    """Recalibrate in-memory arrays -> new quals int8 [N, L].

    The resident path, unless checkpoint_dir is set (pass-boundary saves,
    resume), start_ordinal is not 0 (row r samples as ordinal
    start_ordinal + r), or the data does not fit the card: then the
    windowed engine (``stream_resident.recalibrate_arrays_windowed``),
    which gives the same bytes.  device=None means the CUDA device and
    raises without one; pass device="cpu" to run on the CPU.

    devices: None or 1 is one device; N > 1 runs N ranks of a process group
    (``parallel/``: one per card, or N CPU processes for device="cpu"),
    the same bytes, by the reference's rules: more devices than there are
    and a batch size that N does not divide are refused.  ``bloom_layout``
    "replicated" holds whole filters on every rank, "sharded" 1/N of each
    (the hash-space-sharded layout: N must be a power of two, and a small
    input's filters are bumped as in the reference), "auto" the replicated
    one while both filters hold at most ``REPLICATED_BLOOM_BUDGET`` bits.
    Each rank takes the resident path on its rows when nothing asks for
    the windowed engine and its share fits its card.
    """
    from .. import resolve_device
    dev = resolve_device(device)
    with tracer(timings, dev) as trace:
        # the route's choice (the card's free memory) is a stage of its own
        trace.stage("route")
        if devices is not None and devices > 1:
            trace.stage(None)        # the ranks' stages come from the ranks
            return _run_devices(arrays, config, devices, bloom_layout, dev,
                                timings, chunk_rows, checkpoint_dir,
                                start_ordinal)
        if arrays.num_reads == 0:
            return np.zeros((0, arrays.max_len), np.int8)
        if checkpoint_dir is None and start_ordinal == 0 and \
                fits_resident(arrays, dev, config, chunk_rows):
            from .resident import recalibrate_arrays_resident
            return recalibrate_arrays_resident(
                arrays, config, timings=timings, device=dev,
                chunk_rows=chunk_rows)
        from .stream_resident import recalibrate_arrays_windowed
        return recalibrate_arrays_windowed(
            arrays, config, start_ordinal=start_ordinal,
            checkpoint_dir=checkpoint_dir, device=dev, timings=timings,
            chunk_rows=chunk_rows)


def _run_devices(arrays, config, devices: int, bloom_layout: str, dev,
                 timings, chunk_rows, checkpoint_dir, start_ordinal):
    """``run_pipeline`` on `devices` ranks (the JAX package's
    ``run_pipeline`` for devices > 1, line for line)."""
    from ..parallel import sharded
    from ..parallel.mesh import check_devices
    check_devices(devices, dev.type)
    if config.batch_size % devices:
        raise ValueError(
            f"batch size {config.batch_size} must be divisible by "
            f"--devices {devices}")
    lens = arrays.read_lengths()
    layout = sharded.resolve_layout(
        bloom_layout, config, int(lens.sum()),
        int(np.maximum(lens - config.k + 1, 0).sum()), devices)
    if checkpoint_dir is None and start_ordinal == 0:
        return sharded.run_arrays_sharded(arrays, config, devices, dev.type,
                                          timings, chunk_rows, layout)
    return sharded.sharded_recalibrate_arrays(
        arrays, config, devices, start_ordinal, checkpoint_dir, device=dev,
        timings=timings, chunk_rows=chunk_rows, layout=layout)


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
    only, from a parsed GATKReport (the ``pass4`` stage of the tracer of
    ``run_kwargs["timings"]``); report_out -> the full pipeline, and the
    report of its covariate tables; else the plain pipeline."""
    if apply_report is not None:
        from .. import resolve_device
        from ..gatk_report import read_gatk_report, recal_table_from_report
        dev = resolve_device(run_kwargs.get("device"))
        with tracer(run_kwargs.get("timings"), dev) as trace:
            trace.stage("pass4")
            table = recal_table_from_report(
                read_gatk_report(apply_report), rg_names, arrays.max_len)
            out = apply_table_arrays(arrays, table, device=dev)
            trace.stage(None)
            return out
    if report_out is not None:
        from ..gatk_report import write_gatk_report
        from ..oracle.gatk import captured_tables
        with captured_tables() as cap:
            new_quals = run_pipeline(arrays, config, **run_kwargs)
        write_gatk_report(cap["tables"], rg_names, report_out)
        return new_quals
    return run_pipeline(arrays, config, **run_kwargs)


def _load_fastq_arrays(in_paths, interleaved: bool, trace=OFF):
    """Load FASTQ inputs into one padded ReadArrays (each input file is
    its own read group, DECISIONS.md D8): (fqs, mask_list, arrays).  On
    `trace`: the spans ``fastq.load`` (counter ``fastq.in_bytes``, the
    files' sizes), ``fastq.index`` (the native walk: offsets and
    second-in-pair flags), ``fastq.extract`` (padded arrays and the read
    lengths they carry) and ``fastq.pairing`` (takes the walk's flags, or
    the parity of the ordinals when `interleaved`)."""
    import os

    from ..io.fastq import (_load_bytes, extract_padded_arrays,
                            parse_fastq_bytes)

    fqs = []
    for p in in_paths:
        with trace.span("fastq.load"):
            buf = _load_bytes(p)
        trace.count("fastq.in_bytes", os.path.getsize(p))
        with trace.span("fastq.index"):
            fqs.append(parse_fastq_bytes(buf))
        del buf
    with trace.span("fastq.pairing"):
        if interleaved:
            # D11: interleaved pairing — odd ordinals are second-in-pair
            sec_l = [np.arange(fq.num_reads) % 2 == 1 for fq in fqs]
        else:
            sec_l = [fq.seconds_mask() for fq in fqs]
    with trace.span("fastq.extract"):
        parts = [extract_padded_arrays(fq) for fq in fqs]
        max_len = max((p[0].shape[1] for p in parts if p[0].shape[0]),
                      default=1)
        codes_l, quals_l, mask_l, rg_l, lens_l = [], [], [], [], []
        for rg, (fq, (codes, quals, mask, lens)) in enumerate(
                zip(fqs, parts)):
            pad = max_len - codes.shape[1]
            if pad:
                codes = np.pad(codes, ((0, 0), (0, pad)), constant_values=4)
                quals = np.pad(quals, ((0, 0), (0, pad)))
                mask = np.pad(mask, ((0, 0), (0, pad)))
            codes_l.append(codes)
            quals_l.append(quals)
            mask_l.append(mask)
            rg_l.append(np.full(fq.num_reads, rg, np.int32))
            lens_l.append(lens)
        del parts
        if len(fqs) == 1:
            arrays = ReadArrays(codes_l[0], quals_l[0], mask_l[0], rg_l[0],
                                sec_l[0], lens_l[0])
        else:
            arrays = ReadArrays(
                np.concatenate(codes_l), np.concatenate(quals_l),
                np.concatenate(mask_l), np.concatenate(rg_l),
                np.concatenate(sec_l), np.concatenate(lens_l))
    return fqs, mask_l, arrays


def _write_fastq_outputs(fqs, mask_l, new_quals, out_paths,
                         trace=OFF) -> None:
    """Route per-input qual rows to out_paths (matching list, one
    concatenated sink path, or a writable).  On `trace`: the spans
    ``fastq.render`` (counter ``fastq.out_bytes``, the text rendered) and
    ``fastq.sink``."""
    from ..io.fastq import _write_out, open_fastq_sink, render_fastq_with_quals

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
            with trace.span("fastq.render"):
                text = render_fastq_with_quals(fq, new_quals[s:e],
                                               mask[:fq.num_reads])
            trace.count("fastq.out_bytes", len(text))
            with trace.span("fastq.sink"):
                _write_out(text, out)
            del text
            s = e
    finally:
        if opened is not None:
            opened.close()


def recalibrate_fastq(in_paths, out_paths, config: RecalConfig,
                      interleaved: bool = False, device=None,
                      timings: dict | None = None,
                      report_out: str | None = None,
                      apply_report: str | None = None,
                      checkpoint_dir: str | None = None,
                      devices: int | None = None,
                      bloom_layout: str = "auto") -> dict:
    """FASTQ -> FASTQ recalibration (the reference CLI's main flow), with
    the whole input in host memory (``recalibrate_fastq_streaming`` reads
    it chunk by chunk).

    Accepts one path or a list; each input file is its own read group
    (DECISIONS.md D8).  out_paths: matching list, a single path, or a
    writable (outputs concatenated in input order).  Plain or gzip input,
    plain or BGZF (``.gz``) output.  device=None means the CUDA device
    (raises without one).  `timings`, when given, also gets ``read`` and
    ``write`` (host IO, s), and their spans (``_load_fastq_arrays``,
    ``_write_fastq_outputs``).

    report_out: also write the computed covariates as a GATKReport.
    apply_report: SKIP passes 1-3 and recalibrate from a previously
    written report instead (ApplyBQSR-equivalent; read groups match by
    input path, so pass the same inputs in the same order).
    checkpoint_dir: save passes 1-3 at their boundaries and resume from
    the first one not saved (``run_pipeline``).  devices, bloom_layout: as
    in ``run_pipeline`` (apply_report runs pass 4 alone, on one device).
    """
    from .. import resolve_device
    dev = resolve_device(device)
    if isinstance(in_paths, (str, bytes)):
        in_paths = [in_paths]
    with tracer(timings, dev) as trace:
        trace.stage("read")
        fqs, mask_l, arrays = _load_fastq_arrays(in_paths, interleaved,
                                                 trace)
        new_quals = _run_or_apply(
            arrays, config, [str(p) for p in in_paths], report_out,
            apply_report, device=dev, timings=timings,
            checkpoint_dir=checkpoint_dir, devices=devices,
            bloom_layout=bloom_layout)
        trace.stage("write")
        _write_fastq_outputs(fqs, mask_l, new_quals, out_paths, trace)
        # the mask is each read's first len_i columns: its sum is the lengths'
        return {"num_reads": arrays.num_reads,
                "total_bases": int(sum(int(fq.lengths.sum()) for fq in fqs)),
                "read_groups": len(fqs)}

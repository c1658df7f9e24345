"""Argument parsing + subcommand dispatch.

Counterpart of ``kbbq_tpu/cli/main.py``: the same subcommands
(``recalibrate``, ``applybqsr``, ``benchmark``, ``plot``), flags, defaults,
routing rules, messages and exit codes, onto the port's entry points.
``--devices N`` runs N ranks, one process per card over NCCL (``0``: every
card), with replicated or hash-space-sharded filters (``--bloom-layout``;
``auto`` picks by the filters' size).  ``--multihost`` (or
``JAX_NUM_PROCESSES`` > 1) runs the same command on every host as one group
(``parallel/multihost.py``; ``JAX_COORDINATOR``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``), each host on ``--devices`` local ranks (default: every
card), FASTQ, BAM and CRAM, with the reference's refusals; each host prints
its summary on stderr and its stats as one JSON line on stdout.

Every route runs on the CUDA device; without one it fails with
``resolve_device``'s error.  There is no flag for the CPU: the tests call
``main(argv, device="cpu")``, where ``--devices N`` runs N CPU processes
over gloo.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..constants import DEFAULT_EXT_CAP, DEFAULT_K

SUBCOMMANDS = ("recalibrate", "applybqsr", "benchmark", "plot")
# inputs larger than this stream from disk without --stream
AUTO_STREAM_BYTES = 2 << 30


def _add_recal_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("input", nargs="+",
                   help="input FASTQ(s) (.fq[.gz]; each file = one read "
                        "group) or a BAM")
    p.add_argument("-o", "--output", action="append", default=None,
                   help="output path (repeat for multiple inputs; "
                        "default stdout)")
    p.add_argument("-k", "--kmer-size", type=int, default=DEFAULT_K,
                   help=f"k-mer size, <=32 (default {DEFAULT_K})")
    p.add_argument("-g", "--genome-length", type=int, default=None,
                   help="genome length; coverage = total_bases / g")
    p.add_argument("-c", "--coverage", type=float, default=None,
                   help="sequencing coverage (overrides -g derivation)")
    p.add_argument("-a", "--alpha", type=float, default=None,
                   help="k-mer sampling rate (default 7/coverage)")
    p.add_argument("-u", "--use-oq", action="store_true",
                   help="BAM: read base qualities from the OQ tag")
    p.add_argument("-s", "--set-oq", action="store_true",
                   help="BAM: store original qualities into the OQ tag")
    p.add_argument("--batch-size", type=int, default=2048,
                   help="reads per device batch")
    p.add_argument("--devices", type=int, default=None,
                   help="number of devices to shard the reads axis over, "
                        "one process per card (default 1 = single device; "
                        "0 = all available)")
    p.add_argument("--bloom-layout", default="auto",
                   choices=("auto", "replicated", "sharded"),
                   help="multi-device Bloom placement: per-device replicas "
                        "or hash-space sharded (auto = by filter size; "
                        "sharded needs a power-of-two --devices)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save/resume pass-boundary checkpoints here")
    p.add_argument("--ext-cap", type=int, default=DEFAULT_EXT_CAP,
                   help="substitution-trial extension cap W (clamped to "
                        f"k; default {DEFAULT_EXT_CAP} = extend-to-k, "
                        "the reference's semantics; smaller caps trade "
                        "a recorded output deviation for fewer probes, "
                        "see DECISIONS.md D7)")
    p.add_argument("--fasta-ref", default=None,
                   help="reference FASTA for reference-based CRAM input "
                        "(unneeded when slices embed their reference)")
    p.add_argument("--trust-threshold", type=int, default=None,
                   help="override the coverage-derived trusted-kmer "
                        "threshold T (parity calibration knob, D6)")
    p.add_argument("--interleaved", action="store_true",
                   help="FASTQ: reads alternate read1/read2 (pairing by "
                        "position instead of /2 name suffix)")
    p.add_argument("--stream", action="store_true",
                   help="FASTQ: stream chunks from disk each pass "
                        "(bounded host memory; auto-enabled for inputs "
                        "over ~2 GB)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process run over several hosts: every "
                        "host runs this same command; coordinator/"
                        "process-id resolve from JAX_COORDINATOR, "
                        "JAX_NUM_PROCESSES, JAX_PROCESS_ID (auto-enabled "
                        "when JAX_NUM_PROCESSES > 1); --devices = the "
                        "ranks on each host (default: every card)")
    p.add_argument("--chunk-reads", type=int, default=None,
                   help="reads per streamed chunk (default 131072)")
    p.add_argument("--report-out", default=None, metavar="REPORT",
                   help="also write the computed covariates as a "
                        "GATKReport v1.1 recalibration table")
    p.add_argument("--apply-report", default=None, metavar="REPORT",
                   help="skip model building and recalibrate from a "
                        "previously written GATKReport instead "
                        "(ApplyBQSR-equivalent; FASTQ read groups match "
                        "by input path, BAM/CRAM by RG tag)")


def _devices(args) -> int | None:
    """The device count (``--devices 0`` = every card)."""
    devices = args.devices
    if devices == 0:  # 0 = all available
        import torch
        devices = torch.cuda.device_count()
    return devices


def _over_auto_stream(paths) -> bool:
    return sum(os.path.getsize(p) for p in paths
               if os.path.exists(p)) > AUTO_STREAM_BYTES


def _summary(stats: dict, dt: float) -> None:
    print(f"[kbbq-tpu] recalibrated {stats['num_reads']} reads "
          f"({stats['total_bases']} bases) in {dt:.2f}s "
          f"({stats['num_reads'] / max(dt, 1e-9):.0f} reads/s)",
          file=sys.stderr)


def _finish_multihost(stats: dict, dt: float, out=None,
                      timings: dict | None = None) -> int:
    """A host's epilogue: its summary on stderr, its stats (with its wall
    seconds and `timings`) as one JSON line on stdout, which the launcher
    collects."""
    import json
    part = f" -> {stats['part']}" if out is not None else ""
    cat = f"; `cat {out}.part-* > {out}`" if out is not None else ""
    print(f"[kbbq-tpu] host {stats['process_id']}/{stats['num_processes']}: "
          f"wrote {stats['host_reads_written']} of {stats['num_reads']} "
          f"reads{part} in {dt:.2f}s ({stats['devices']} devices){cat}",
          file=sys.stderr)
    print(json.dumps({**stats, "wall_s": round(dt, 3),
                      "timings": timings or {}}), flush=True)
    return 0


def _multihost(args, cfg, report_out, apply_report) -> int:
    """The multi-host routes, with the reference's refusals."""
    from ..parallel import multihost as mh

    first = args.input[0]
    if first.endswith(".sam"):
        raise SystemExit("multi-host mode supports FASTQ, BAM and CRAM "
                         "inputs; convert SAM to BAM first")
    out = None
    if first.endswith(".cram"):
        if len(args.input) != 1:
            raise SystemExit("multi-host CRAM mode takes one input")
        if args.set_oq:
            raise SystemExit("--set-oq with multi-host CRAM is unsupported "
                             "(it changes tag streams; use the whole-file "
                             "path)")
        out = (args.output or ["out.cram"])[0]
        route, inputs = mh.recalibrate_cram_multihost, (first, out)
        kw = dict(use_oq=args.use_oq, fasta_ref=args.fasta_ref)
    elif first.endswith(".bam"):
        if len(args.input) != 1:
            raise SystemExit("multi-host BAM mode takes one input")
        out = (args.output or ["out.bam"])[0]
        route, inputs = mh.recalibrate_bam_multihost, (first, out)
        kw = dict(use_oq=args.use_oq, set_oq=args.set_oq,
                  chunk_records=args.chunk_reads)
    else:
        if args.output is None or len(args.output) != len(args.input):
            raise SystemExit("multi-host mode needs one -o output per input "
                             "file (a single concatenated sink is impossible "
                             "across hosts)")
        route, inputs = mh.recalibrate_fastq_multihost, (args.input,
                                                         args.output)
        kw = dict(interleaved=args.interleaved, chunk_reads=args.chunk_reads)
    timings: dict = {}
    info = mh.init_multihost()
    t0 = time.time()
    stats = route(*inputs, cfg, info=info, timings=timings,
                  checkpoint_dir=args.checkpoint_dir,
                  bloom_layout=args.bloom_layout, report_out=report_out,
                  apply_report=apply_report, devices=args.devices,
                  device=getattr(args, "device", None), **kw)
    return _finish_multihost(stats, time.time() - t0, out, timings)


def cmd_recalibrate(args) -> int:
    from ..pipeline import RecalConfig

    cfg = RecalConfig(
        k=args.kmer_size, alpha=args.alpha, coverage=args.coverage,
        genome_length=args.genome_length, batch_size=args.batch_size,
        trust_threshold=args.trust_threshold, ext_cap=args.ext_cap)
    report_out = getattr(args, "report_out", None)
    apply_report = getattr(args, "apply_report", None)
    if apply_report and report_out:
        raise SystemExit("--apply-report and --report-out are exclusive")
    if args.multihost or int(os.environ.get("JAX_NUM_PROCESSES", "1")) > 1:
        return _multihost(args, cfg, report_out, apply_report)
    devices = _devices(args)
    common = dict(checkpoint_dir=args.checkpoint_dir, report_out=report_out,
                  apply_report=apply_report,
                  device=getattr(args, "device", None))
    multi = dict(devices=devices, bloom_layout=args.bloom_layout)
    outs = args.output or ["-"]
    outs = [sys.stdout.buffer if o == "-" else o for o in outs]
    t0 = time.time()
    if args.input[0].endswith(".cram"):
        if len(args.input) != 1:
            raise SystemExit("CRAM mode takes exactly one input")
        # the container-windowed route runs on one device only
        stream_cram = (args.stream or _over_auto_stream(args.input)) \
            and (devices or 1) <= 1 and not args.set_oq \
            and str(outs[0]).endswith(".cram")
        if stream_cram:
            # a window per container, pass 4 rewrites only the QS blocks
            from ..pipeline import recalibrate_cram_stream_resident
            stats = recalibrate_cram_stream_resident(
                args.input[0], outs[0], cfg, use_oq=args.use_oq,
                fasta_ref=args.fasta_ref, **common)
        else:
            from ..pipeline import recalibrate_cram
            stats = recalibrate_cram(args.input[0], outs[0], cfg,
                                     use_oq=args.use_oq, set_oq=args.set_oq,
                                     fasta_ref=args.fasta_ref, **common,
                                     **multi)
    elif args.input[0].endswith((".bam", ".sam")):
        if len(args.input) != 1:
            raise SystemExit("BAM mode takes exactly one input")
        if args.input[0].endswith(".bam") and \
                (args.stream or _over_auto_stream(args.input)):
            from ..pipeline import recalibrate_bam_streaming
            stats = recalibrate_bam_streaming(
                args.input[0], outs[0], cfg, use_oq=args.use_oq,
                set_oq=args.set_oq, chunk_records=args.chunk_reads,
                **common, **multi)
        else:
            from ..pipeline import recalibrate_bam
            stats = recalibrate_bam(args.input[0], outs[0], cfg,
                                    use_oq=args.use_oq, set_oq=args.set_oq,
                                    **common, **multi)
    else:
        sink = outs if len(outs) > 1 else outs[0]
        if args.stream or _over_auto_stream(args.input):
            from ..io.stream import DEFAULT_CHUNK_READS
            from ..pipeline import recalibrate_fastq_streaming
            stats = recalibrate_fastq_streaming(
                args.input, sink, cfg, interleaved=args.interleaved,
                chunk_reads=args.chunk_reads or DEFAULT_CHUNK_READS,
                **common, **multi)
        else:
            from ..pipeline import recalibrate_fastq
            stats = recalibrate_fastq(args.input, sink, cfg,
                                      interleaved=args.interleaved, **common,
                                      **multi)
    _summary(stats, time.time() - t0)
    return 0


def cmd_applybqsr(args) -> int:
    args.apply_report = args.report
    args.report_out = None
    return cmd_recalibrate(args)


def cmd_benchmark(args) -> int:
    from ..benchmark import benchmark_to_tsv
    return benchmark_to_tsv(args)


def cmd_plot(args) -> int:
    from ..plot import plot_benchmark
    plot_benchmark(args.input, args.output)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kbbq-tpu-torch",
        description="reference-free base quality recalibration on a CUDA "
                    "device (the PyTorch port of kbbq-tpu)")
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("recalibrate", help="recalibrate FASTQ/BAM qualities")
    _add_recal_args(pr)
    pr.set_defaults(fn=cmd_recalibrate)

    # ApplyBQSR-equivalent: `applybqsr -r report in -o out` ==
    # `recalibrate --apply-report report in -o out`
    pa = sub.add_parser(
        "applybqsr",
        help="recalibrate from an existing GATKReport (no model build)")
    _add_recal_args(pa)
    pa.add_argument("-r", "--report", required=True,
                    help="GATKReport recalibration table to apply")
    pa.set_defaults(fn=cmd_applybqsr)

    pb = sub.add_parser(
        "benchmark",
        help="measure actual per-quality error rates from aligned reads")
    pb.add_argument("-b", "--bam", required=True,
                    help="aligned, coordinate-sorted BAM or CRAM")
    pb.add_argument("-r", "--reference", required=True,
                    help="reference FASTA")
    pb.add_argument("-v", "--vcf", required=True,
                    help="VCF of variable sites to exclude")
    pb.add_argument("-f", "--fastq", default=None,
                    help="optional recalibrated FASTQ to score instead")
    pb.add_argument("-l", "--label", default="kbbq-tpu")
    pb.add_argument("-o", "--output", default="-")
    pb.set_defaults(fn=cmd_benchmark)

    pp = sub.add_parser("plot", help="plot calibration curves")
    pp.add_argument("input", help="benchmark TSV")
    pp.add_argument("output", help="output image (pdf/png)")
    pp.set_defaults(fn=cmd_plot)
    return p


def main(argv=None, device=None) -> int:
    """Run one subcommand; returns the exit code.  `device` is where the
    recalibrating routes run (None: the CUDA device)."""
    if argv is None:
        argv = sys.argv[1:]
    # the reference's `kbbq [opts] input` with no subcommand is an implicit
    # `recalibrate`
    if argv and argv[0] not in (*SUBCOMMANDS, "-h", "--help"):
        argv = ["recalibrate", *argv]
    args = build_parser().parse_args(argv)
    args.device = device
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"kbbq-tpu: error: {e}", file=sys.stderr)
        return 2
    except (ValueError, OSError) as e:
        print(f"kbbq-tpu: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The port's multi-device routes across the cards of one host.

    python3 scripts/torch_devices_check.py             # every card
    python3 scripts/torch_devices_check.py --reads N   # a smaller dataset
    python3 scripts/torch_devices_check.py --only devices     # one host
    python3 scripts/torch_devices_check.py --only multihost   # several
    python3 scripts/torch_devices_check.py --only scale       # config 4

Needs two CUDA cards or more: one NCCL rank per card, so the collectives
and the point-to-point sends run between cards (``chip_smoke.py`` runs the
same routes at one rank on a one-card machine).  Builds the kernels and the
host codec from this checkout, draws chip_smoke.py's config 2 dataset
(1,533,333 reads x 150 from a seed), writes the one-device bytes with
``recalibrate_fastq``, then runs chip_smoke.py's ``[devices]`` phase at
D = the card count (run_pipeline's multi-device route at D and at 2 ranks;
the streamed route on D ranks with a checkpoint, then resumed after pass
2), its ``[sharded]`` phase at D and at 2 ranks (the hash-space-sharded
filters: the resident route, the streamed route with a checkpoint, then
resumed after pass 2) and the command line with ``--devices 0`` and with
``--devices 0 --bloom-layout sharded``.  Then several hosts
(``chip_smoke.py``'s ``[multihost]`` phase): host processes on this
machine, one NCCL group over them, at 2 hosts x D/2 cards and D hosts x 1
card, each filter layout on FASTQ (config 2 as 4 files), BAM and CRAM
(config 3, the same reads), and at 2 hosts one FASTQ run killed between
pass 1 and pass 2 and resumed; the single host's bytes or, for BAM parts,
records.  ``--only devices`` runs the single-host multi-card phases and
``--only multihost`` the multi-host routes, each with the single-host runs
it is held to, and nothing else.  ``--only scale`` runs BASELINE config 4
alone (``chip_smoke.py``'s ``[scale]`` data: 13,000,000 reads x 150 at
30x, filters of 2^31 bits): one device's resident bytes, then
run_pipeline's multi-device route at D and 2 ranks with the sharded layout
(config 4's layout in BASELINE: filters sharded over one host's cards) and
at D with the replicated one, walls, spawn, exchanges and peak device
bytes by rank.  Every run must write the
one-device bytes, its launches asserted by entry point (by rank for the
sharded layout).  Any difference raises, so the exit code is non-zero; the last
two lines are the card's name and power limit and a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=1_533_333)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("devices", "multihost", "scale"),
                    help="only the single-host multi-card phases, only "
                         "the multi-host routes (default: both), or only "
                         "config 4")
    args = ap.parse_args(argv)

    import torch
    D = torch.cuda.device_count()
    if D < 2:
        print(f"needs two CUDA cards or more, found {D}", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.io import native_lib
    from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_bam,
                                         recalibrate_cram_stream_resident,
                                         recalibrate_fastq)
    from kbbq_tpu_torch.utils.synth import (arrays_to_bam_bytes,
                                            arrays_to_cram_bytes,
                                            arrays_to_fastq_bytes,
                                            make_arrays_fast, read_starts)

    t_start = time.time()
    cs.log(f"[devices_check] {D} cards; {cs.smi_line()}")
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    kernels.library()
    native_lib.library()
    if args.only == "scale":
        summary = scale_phases(cs.SCALE_READS, args.seed, D)
        print(cs.smi_line(), flush=True)
        print(json.dumps({"cards": D, **summary,
                          "seconds": time.time() - t_start}), flush=True)
        return 0
    genome_len = max(10_000, int(4_600_000 * args.reads / cs.FULL_READS))
    arrays, _ = make_arrays_fast(genome_len=genome_len, read_len=150,
                                 num_reads=args.reads, error_rate=0.005,
                                 seed=args.seed, paired=True)
    cfg = RecalConfig(k=32, coverage=50.0, batch_size=8192)
    tmp = tempfile.mkdtemp(prefix="kbbq_devices_")
    summary: dict = {}
    try:
        src, want = (os.path.join(tmp, n) for n in ("reads.fq", "out1.fq"))
        with open(src, "wb") as f:
            f.write(arrays_to_fastq_bytes(arrays))
        multihost = args.only != "devices"
        if multihost:      # config 3: the same reads as a BAM and a CRAM
            starts = read_starts(genome_len, 150, args.reads, args.seed)
            for fmt, make in (("bam", arrays_to_bam_bytes),
                              ("cram", arrays_to_cram_bytes)):
                data, _ = make(arrays, starts, extra_share=cs.BAM_EXTRA_SHARE)
                with open(os.path.join(tmp, f"reads.{fmt}"), "wb") as f:
                    f.write(data)
                del data
            del starts
        del arrays
        kernels.reset_launches()
        t0 = time.time()
        recalibrate_fastq(src, want, cfg)
        torch.cuda.synchronize()
        one_wall = time.time() - t0
        one = dict(kernels.ENTRY_LAUNCHES)
        cs.log(f"[devices_check] one device: {one_wall:.3f} s, launches "
               f"{json.dumps(one)}")
        summary.update(one_device_wall_s=one_wall, one_device_launches=one)
        if args.only != "multihost":
            summary.update(devices_phases(tmp, src, want, cfg, args.reads, D))
        if multihost:
            recalibrate_bam(os.path.join(tmp, "reads.bam"),
                            os.path.join(tmp, "bam1.bam"), cfg, set_oq=True)
            recalibrate_cram_stream_resident(
                os.path.join(tmp, "reads.cram"),
                os.path.join(tmp, "cram1.cram"), cfg)
            routes = [(fmt, layout) for fmt in ("fastq", "bam", "cram")
                      for layout in ("replicated", "sharded")]
            summary["multihost"] = [
                cs.phase_multihost(tmp, cfg, hosts, D // hosts, routes,
                                   kill=hosts == 2)
                for hosts in sorted({2, D})]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(cs.smi_line(), flush=True)
    print(json.dumps({"cards": D, "reads": args.reads, **summary,
                      "seconds": time.time() - t_start}), flush=True)
    return 0


def scale_phases(reads: int, seed: int, D: int) -> dict:
    """Config 4 on the cards: its FASTQ (``chip_smoke.start_scale_data``),
    one device's resident bytes, then ``chip_smoke.phase_devices_scale`` at
    D and 2 ranks sharded and at D replicated, each those bytes."""
    import torch

    import chip_smoke as cs
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_fastq
    from kbbq_tpu_torch.pipeline.recalibrate import _load_fastq_arrays
    job = cs.start_scale_data(reads, seed)
    try:
        out, err = job["proc"].communicate(timeout=1800)
        if job["proc"].returncode != 0:
            raise AssertionError(f"config 4's data generator failed: "
                                 f"{err[-3000:]}")
        made = json.loads(out.strip().splitlines()[-1])
        tmp, src, n = job["tmp"], job["src"], job["reads"]
        cfg = RecalConfig(k=32, coverage=cs.SCALE_COVERAGE)
        want = os.path.join(tmp, "one.fq")
        t: dict = {}
        kernels.reset_launches()
        t0 = time.time()
        recalibrate_fastq([src], want, cfg, interleaved=True, timings=t)
        torch.cuda.synchronize()
        one_wall = time.time() - t0
        one = dict(kernels.ENTRY_LAUNCHES)
        cs.check_launches("config 4 on one device", one,
                          cs.resident_ranks_launches(n, 1))
        cs.log(f"[scale] {n} reads (data {json.dumps(made)}); one device: "
               f"{one_wall:.3f} s, stages {json.dumps(t)}")
        arrays = _load_fastq_arrays([src], True)
        runs = [cs.phase_devices_scale(tmp, src, want, cfg, n, world, layout,
                                       arrays)
                for world, layout in ((D, "sharded"), (2, "sharded"),
                                      (D, "replicated"))]
    finally:
        cs.stop_scale_data(job)
    return {"scale_reads": n, "data": made, "one_device_wall_s": one_wall,
            "one_device_timings": t, "one_device_launches": one,
            "runs": runs}


def devices_phases(tmp, src, want, cfg, reads: int, D: int) -> dict:
    """chip_smoke.py's [devices] and [sharded] phases at D (and 2) ranks and
    the command line's --devices 0 with each layout."""
    import chip_smoke as cs
    by_rank, launches = cs.phase_devices(tmp, cfg, reads)
    sharded = {}
    for world in sorted({D, 2}, reverse=True):
        t0 = time.time()
        sh_by_rank, _, sh_streamed = cs.phase_sharded(tmp, cfg, reads, world)
        sharded[world] = {"launches_by_rank": sh_by_rank,
                          "streamed_launches": sh_streamed,
                          "seconds": time.time() - t0}
    cli_out = os.path.join(tmp, "cli.fq")
    cli = {}
    for layout in ("auto", "sharded"):
        rc, wall, last, by_entry, _ = cs.run_cli(
            tmp, ["recalibrate", src, "-o", cli_out, "--devices", "0",
                  "--bloom-layout", layout, "-k", str(cfg.k), "-c",
                  f"{cfg.coverage:g}", "--batch-size", str(cfg.batch_size)],
            reads, name=f"devices_0_{layout}")
        if layout == "auto":
            cs.check_launches(f"command line --devices 0 ({D} cards)",
                              by_entry, cs.resident_ranks_launches(reads, D))
        elif not by_entry["walk_propose"] or by_entry["walk_errors"]:
            raise AssertionError(f"--bloom-layout sharded launched "
                                 f"{by_entry}")
        if not cs.same_file(cli_out, want):
            raise AssertionError(f"--devices 0 --bloom-layout {layout} "
                                 f"wrote other bytes than one device")
        cli[layout] = {"wall_s": wall, "stderr": last, "launches": by_entry}
    return {"resident_launches_by_rank": by_rank,
            "resident_launches": launches, "sharded": sharded,
            "cli_devices_0": cli}


if __name__ == "__main__":
    sys.exit(main())

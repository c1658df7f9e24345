#!/usr/bin/env python3
"""The port's multi-device routes across the cards of one host.

    python3 scripts/torch_devices_check.py             # every card
    python3 scripts/torch_devices_check.py --reads N   # a smaller dataset

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
``--devices 0 --bloom-layout sharded``.  Every run must write the
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
    args = ap.parse_args(argv)

    import torch
    D = torch.cuda.device_count()
    if D < 2:
        print(f"needs two CUDA cards or more, found {D}", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.io import native_lib
    from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_fastq
    from kbbq_tpu_torch.utils.synth import (arrays_to_fastq_bytes,
                                            make_arrays_fast)

    t_start = time.time()
    cs.log(f"[devices_check] {D} cards; {cs.smi_line()}")
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    kernels.library()
    native_lib.library()
    genome_len = max(10_000, int(4_600_000 * args.reads / cs.FULL_READS))
    arrays, _ = make_arrays_fast(genome_len=genome_len, read_len=150,
                                 num_reads=args.reads, error_rate=0.005,
                                 seed=args.seed, paired=True)
    cfg = RecalConfig(k=32, coverage=50.0, batch_size=8192)
    tmp = tempfile.mkdtemp(prefix="kbbq_devices_")
    try:
        src, want = (os.path.join(tmp, n) for n in ("reads.fq", "out1.fq"))
        with open(src, "wb") as f:
            f.write(arrays_to_fastq_bytes(arrays))
        del arrays
        kernels.reset_launches()
        t0 = time.time()
        recalibrate_fastq(src, want, cfg)
        torch.cuda.synchronize()
        one_wall = time.time() - t0
        one = dict(kernels.ENTRY_LAUNCHES)
        cs.log(f"[devices_check] one device: {one_wall:.3f} s, launches "
               f"{json.dumps(one)}")
        by_rank, launches = cs.phase_devices(tmp, cfg, args.reads)
        sharded = {}
        for world in sorted({D, 2}, reverse=True):
            t0 = time.time()
            sh_by_rank, _, sh_streamed = cs.phase_sharded(tmp, cfg,
                                                          args.reads, world)
            sharded[world] = {"launches_by_rank": sh_by_rank,
                              "streamed_launches": sh_streamed,
                              "seconds": time.time() - t0}
        cli_out = os.path.join(tmp, "cli.fq")
        cli = {}
        for layout in ("auto", "sharded"):
            rc, wall, last, by_entry, _ = cs.run_cli(
                tmp, ["recalibrate", src, "-o", cli_out, "--devices", "0",
                      "--bloom-layout", layout, "-k", str(cfg.k), "-c",
                      f"{cfg.coverage:g}", "--batch-size",
                      str(cfg.batch_size)], args.reads,
                name=f"devices_0_{layout}")
            if layout == "auto":
                cs.check_launches(f"command line --devices 0 ({D} cards)",
                                  by_entry,
                                  cs.resident_ranks_launches(args.reads, D))
            elif not by_entry["walk_propose"] or by_entry["walk_errors"]:
                raise AssertionError(f"--bloom-layout sharded launched "
                                     f"{by_entry}")
            if not cs.same_file(cli_out, want):
                raise AssertionError(f"--devices 0 --bloom-layout {layout} "
                                     f"wrote other bytes than one device")
            cli[layout] = {"wall_s": wall, "stderr": last,
                           "launches": by_entry}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(cs.smi_line(), flush=True)
    print(json.dumps({"cards": D, "reads": args.reads,
                      "one_device_wall_s": one_wall,
                      "one_device_launches": one,
                      "resident_launches_by_rank": by_rank,
                      "resident_launches": launches,
                      "sharded": sharded,
                      "cli_devices_0": cli,
                      "seconds": time.time() - t_start}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

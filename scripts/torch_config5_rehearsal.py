#!/usr/bin/env python3
"""Config-5 rehearsal of the PyTorch/CUDA port: filters forced to WGS size
under the hash-space-sharded layout over several host processes.

    python3 scripts/torch_config5_rehearsal.py                # 2^33, 2 x 1
    python3 scripts/torch_config5_rehearsal.py --reads 1500000 \
        --log2-m 33,35 --shapes 2x2,4x1

The port of ``scripts/config5_rehearsal.py``.  Three FASTQ files at its
shapes (seeds 71, 72, 73; 50 bp; k = 16; 20x over the three; error rate
0.02; ``--reads`` in all, by ``make_dataset``, or from 100,000 reads on by
``make_arrays_fast``, whose per-read loop-free draw plants errors at a
uniform rate), both filters forced to 2^log2_m bits by
``RecalConfig(min_log2_m=...)``.  For each size, the golden is one process
of the sharded layout at D = H x L ranks (``recalibrate_fastq(...,
devices=D, bloom_layout="sharded")``; at D = 1 that is the single-device
route, whose bytes the layout gives at one rank); for each shape H x L, H
host processes of L ranks each (``recalibrate_fastq_multihost(...,
bloom_layout="sharded")``, each host's cards by CUDA_VISIBLE_DEVICES) must
write the golden's bytes, every rank holding m/32/D words of each filter.
On the card the same pod also runs at the default sizing, and each rank's
rise in peak device bytes during pass 2 (both filters held) must be
2 (2^log2_m - 2^log2_m0) / 8 / D bytes (the two filters' growth on one
shard) within one exchange chunk's bytes; each host's peak resident set is
reported.  Any failed check raises, so the exit code is non-zero; the last
line is a JSON summary, the line before it the card's name and power
limit.
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

K = 16
COVERAGE = 20.0
READ_LEN = 50
ERROR_RATE = 0.02
SEEDS = (71, 72, 73)
READS = 12_000
FAST_STAGING_READS = 100_000     # from here on, make_arrays_fast stages
HOST_TIMEOUT = 1800


def _log(msg):
    print(f"[config5 {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def stage(tmp: str, reads: int) -> list:
    """The three input files, `reads` reads in all -> their paths."""
    from kbbq_tpu_torch.utils.synth import (arrays_to_fastq_file,
                                            make_arrays_fast, make_dataset,
                                            to_fastq_bytes)
    cov = COVERAGE / len(SEEDS)
    paths = []
    for i, seed in enumerate(SEEDS):
        n = reads // len(SEEDS) + (i < reads % len(SEEDS))
        genome_len = max(400, int(n * READ_LEN / cov))
        while int(genome_len * cov / READ_LEN) < n:   # make_dataset's count
            genome_len += 1
        path = os.path.join(tmp, f"in{i}.fq")
        if reads >= FAST_STAGING_READS:
            arrays, _ = make_arrays_fast(genome_len=genome_len,
                                         read_len=READ_LEN, num_reads=n,
                                         error_rate=ERROR_RATE, seed=seed,
                                         paired=False)
            arrays_to_fastq_file(arrays, path)
        else:
            ds = make_dataset(genome_len=genome_len, read_len=READ_LEN,
                              coverage=cov, error_rate=ERROR_RATE,
                              seed=seed)
            with open(path, "wb") as f:
                f.write(to_fastq_bytes(ds))
        paths.append(path)
    return paths


def _config(log2_m: int | None, world: int) -> dict:
    return {"k": K, "coverage": COVERAGE, "batch_size": 64 * world,
            "min_log2_m": log2_m}


def worker(job: dict) -> None:
    """One host of the pod: its part of the run, then its stats line."""
    import resource

    from kbbq_tpu_torch.parallel.multihost import recalibrate_fastq_multihost
    from kbbq_tpu_torch.pipeline import RecalConfig
    from kbbq_tpu_torch.utils.metrics import peak_rss_bytes
    t: dict = {}
    t0 = time.time()
    stats = recalibrate_fastq_multihost(
        job["paths"], job["outs"], RecalConfig(**job["config"]),
        bloom_layout="sharded", devices=job["local"], device=job["device"],
        timings=t)
    # the largest peak resident set of a child (a spawned rank)
    children = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024
    own = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(json.dumps({**stats, "wall_s": time.time() - t0, "timings": t,
                      "peak_rss_bytes": peak_rss_bytes(),
                      "ru_maxrss_bytes": own,
                      "children_max_rss_bytes": children}), flush=True)


def pod(tmp, paths, outs, config, hosts: int, local: int, device: str,
        name: str):
    """H host processes of L ranks each on `device` ("cuda" or "cpu") ->
    (wall s, each host's stats)."""
    import chip_smoke as cs
    job = {"paths": paths, "outs": outs, "config": config, "local": local,
           "device": device}
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           json.dumps(job)]
    return cs.run_hosts(tmp, [], hosts, local, name, cmd=cmd,
                        timeout=HOST_TIMEOUT)


def rehearse(reads: int = READS, log2_ms=(33,), shapes=((2, 1),),
             device=None, tmp: str | None = None) -> dict:
    """The rehearsal (module docstring) -> its summary; raises on any
    difference.  device=None means the cards; device="cpu" runs gloo
    ranks (then no device bytes are measured)."""
    import torch

    import chip_smoke as cs
    from kbbq_tpu_torch import resolve_device
    from kbbq_tpu_torch.parallel.sharded_bloom import (
        EXCHANGE_BYTES_PER_ENTRY, EXCHANGE_CHUNK, sharded_params)
    from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_fastq
    from kbbq_tpu_torch.io.stream import scan_fastq_files

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    own = tmp is None
    tmp = tmp or tempfile.mkdtemp(prefix="kbbq_config5_")
    summary: dict = {"reads": reads, "runs": []}
    try:
        t0 = time.time()
        paths = stage(tmp, reads)
        scan = scan_fastq_files(paths, K)
        summary.update(staged_reads=scan.num_reads,
                       stage_s=time.time() - t0)
        _log(f"{scan.num_reads} reads in {len(paths)} files, "
             f"{time.time() - t0:.1f} s")
        base: dict = {}
        for H, L in shapes if cuda else ():    # default sizing, for the rise
            D = H * L
            cfg = _config(None, D)
            outs = [os.path.join(tmp, f"base_{H}x{L}_{i}.fq")
                    for i in range(len(paths))]
            wall, stats = pod(tmp, paths, outs, cfg, H, L, dev.type,
                              f"base_{H}x{L}")
            base[(H, L)] = stats
            _log(f"default sizing, {H} x {L}: {wall:.3f} s")
        for lm in log2_ms:
            goldens = {}
            for H, L in shapes:
                D = H * L
                cfg = _config(lm, D)
                if D not in goldens:
                    want = [os.path.join(tmp, f"want_{lm}_{D}_{i}.fq")
                            for i in range(len(paths))]
                    t0 = time.time()
                    recalibrate_fastq(paths, want, RecalConfig(**cfg),
                                      devices=D, bloom_layout="sharded",
                                      device=dev)
                    goldens[D] = (want, time.time() - t0)
                    _log(f"2^{lm}: one process at D = {D}: "
                         f"{goldens[D][1]:.3f} s")
                want = goldens[D][0]
                outs = [os.path.join(tmp, f"pod_{lm}_{H}x{L}_{i}.fq")
                        for i in range(len(paths))]
                wall, stats = pod(tmp, paths, outs, cfg, H, L, dev.type,
                                  f"pod_{lm}_{H}x{L}")
                for i, (a, b) in enumerate(zip(outs, want)):
                    if not cs.same_file(a, b):
                        raise AssertionError(
                            f"2^{lm}, {H} x {L}: file {i} differs from the "
                            f"single-process sharded run")
                alpha, cov = RecalConfig(**cfg).resolve_alpha(
                    scan.total_bases)
                pa, pb = sharded_params(RecalConfig(**cfg),
                                        scan.total_kmers(K), alpha, cov, D)
                by_rank = [r for s in stats for r in s["timings"]["by_rank"]]
                words = [(r["shard_words_a"], r["shard_words_b"])
                         for r in by_rank]
                if words != [(pa.m // 32 // D, pb.m // 32 // D)] * D:
                    raise AssertionError(f"2^{lm}, {H} x {L}: shard words "
                                         f"{words}, not m/32/D each")
                rec = {"log2_m": lm, "log2_m_a": pa.log2_m,
                       "log2_m_b": pb.log2_m, "hosts": H, "local": L,
                       "world": D, "golden_wall_s": goldens[D][1],
                       "wall_s": wall, "shard_words": words[0],
                       "host_wall_s": [s["wall_s"] for s in stats],
                       "spawn_s": [s["timings"]["spawn"] for s in stats],
                       "exchange_s": [s["timings"]["exchange"]
                                      for s in stats],
                       "exchange_bytes": [s["timings"]["exchange_bytes"]
                                          for s in stats],
                       "host_peak_rss_bytes": [s["peak_rss_bytes"]
                                               for s in stats],
                       "host_ru_maxrss_bytes": [s["ru_maxrss_bytes"]
                                                for s in stats],
                       "children_max_rss_bytes": [
                           s["children_max_rss_bytes"] for s in stats]}
                if cuda:
                    b_rank = [r for s in base[(H, L)]
                              for r in s["timings"]["by_rank"]]
                    b0 = [(r["shard_words_a"], r["shard_words_b"])
                          for r in b_rank]
                    grow = [4 * (pa.m // 32 // D - wa) + 4 * (pb.m // 32 // D
                                                              - wb)
                            for wa, wb in b0]
                    rise = [r["pass2_peak_bytes"] - b["pass2_peak_bytes"]
                            for r, b in zip(by_rank, b_rank)]
                    slack = EXCHANGE_CHUNK * EXCHANGE_BYTES_PER_ENTRY
                    rec.update(
                        peak_device_bytes=[max(v for n, v in r.items()
                                               if n.endswith("_peak_bytes"))
                                           for r in by_rank],
                        pass2_peak_bytes=[r["pass2_peak_bytes"]
                                          for r in by_rank],
                        base_pass2_peak_bytes=[b["pass2_peak_bytes"]
                                               for b in b_rank],
                        rise_bytes=rise, expected_rise_bytes=grow)
                    if any(abs(r - g) > slack for r, g in zip(rise, grow)):
                        raise AssertionError(
                            f"2^{lm}, {H} x {L}: pass-2 peak rose by {rise} "
                            f"B, expected {grow} B within {slack} B")
                summary["runs"].append(rec)
                _log(json.dumps(rec))
    finally:
        if own:
            shutil.rmtree(tmp, ignore_errors=True)
    if cuda:
        from kbbq_tpu_torch.utils.metrics import smi_line
        summary["card"] = smi_line()
        summary["device_kind"] = torch.cuda.get_device_name(0)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=READS)
    ap.add_argument("--log2-m", default="33",
                    help="comma list of filter sizes, log2 bits")
    ap.add_argument("--shapes", default="2x1",
                    help="comma list of hosts x ranks per host")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(json.loads(args.worker))
        return 0
    shapes = [tuple(int(x) for x in s.split("x"))
              for s in args.shapes.split(",")]
    summary = rehearse(args.reads, [int(x) for x in args.log2_m.split(",")],
                       shapes)
    print(summary["card"], flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kbbq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full size, needs one CUDA card and nvcc
    python3 chip_smoke.py --reads N  # a smaller main-path dataset (debugging)

Builds the CUDA kernels from kbbq_tpu_torch/csrc, holds each against its
plain PyTorch version on the card at the shapes the main path gives it, runs
the two golden checks on the card, then drives the port's main path
(FASTQ -> FASTQ through ``recalibrate_fastq``) at the size of BASELINE.json
config 2: E. coli-like 4.6 Mb genome, 2x150 bp, ~50x, 1,533,333 reads made
from a seed.  Any failed phase raises, so the exit code is non-zero; without
a CUDA device the script exits 1 at once and prints no result.

Output, last three lines: a JSON object {"kernels": [...]} (one entry per
kernel: launches on the main path, mismatches against the plain version,
times in ms, the roofline bound), the card's name and power limit as
nvidia-smi gives them, and {"ok": true, "device": {...}}.

Tolerance: exact equality everywhere.  Every compared quantity is a bool, an
integer or a byte; the kernels do integer arithmetic only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")

# NVIDIA H100 SXM data sheet: device memory rate, and the float32 rate
# outside the tensor cores, taken as the ceiling for the kernels' 32/64-bit
# integer operations (the integer pipes are no faster)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

FULL_READS = 1_533_333
WALK_READS = 65_536          # rows of the walk kernel's check = one chunk
KERNEL_SOURCE = "kbbq_tpu_torch/csrc/kbbq_kernels.cu"
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int = 3, before=None) -> float:
    """Median device time of fn() over `reps` launches (CUDA events), after
    one warm-up; `before` runs untimed ahead of every launch."""
    ts = []
    for i in range(reps + 1):
        if before is not None:
            before()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        if i:
            ts.append(s.elapsed_time(e))
    return float(np.median(ts))


def bound(bytes_moved: float, ops: float):
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a != b).sum().item())


# --------------------------------------------------------------- phases

def phase_device():
    from kbbq_tpu_torch import kernels
    log(f"[device] {smi_line()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([kernels._find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout
    log("[device] nvcc " + " ".join(
        ln.strip() for ln in nvcc.splitlines() if "release" in ln))
    # always from the sources of this checkout
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    kernels.library()
    log(f"[device] built {KERNEL_SOURCE} in {kernels.build_seconds:.1f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("[device]   " + line.strip())


def phase_kernels(arrays, cfg):
    """Each kernel against its plain version on the card, on the main
    path's own state: the hash cache of all windows of the dataset and the
    filters built from it.  The walk's plain version runs over EVERY chunk,
    and its error masks go on through the histogram, the delta math and the
    gather, so the phase also yields the qualities that the main path must
    write.  Returns the per-kernel records (without the main path's launch
    counts) and those qualities, int8 [N, L] on the host."""
    from kbbq_tpu_torch.ops import bloom as tb
    from kbbq_tpu_torch.ops.inference import infer_errors, infer_errors_plain
    from kbbq_tpu_torch.ops.kmers import canonical_kmers_batch, u32_to_wide
    from kbbq_tpu_torch.ops.trusted import trusted_mask_batch
    from kbbq_tpu_torch.oracle import (alpha_threshold, bloom_params_for,
                                       coverage_thresholds)
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.ops.covariate import (accumulate_covariates,
                                              new_covariate_state)
    from kbbq_tpu_torch.ops.recal import apply_recal_table
    from kbbq_tpu_torch.oracle.covariate import CovariateTables
    from kbbq_tpu_torch.oracle.gatk import build_recal_table
    from kbbq_tpu_torch.pipeline.resident import (DEFAULT_CHUNK_ROWS,
                                                  hash_cache_chunk)

    dev = torch.device(DEVICE)
    k, h = cfg.k, cfg.num_hashes
    N, L = arrays.codes.shape
    n = L - k + 1
    rows = DEFAULT_CHUNK_ROWS
    alpha, coverage = cfg.resolve_alpha(N * L)
    pa, pb = bloom_params_for(cfg, N * n, alpha, coverage)
    log(f"[kernels] {N} reads x {L}, {N * n} windows, filter A 2^{pa.log2_m}"
        f" B 2^{pb.log2_m} bits, chunk {rows} rows")

    codes = torch.from_numpy(arrays.codes).to(dev)
    h1 = torch.empty((N, n), dtype=torch.int32, device=dev)
    word = torch.empty_like(h1)
    keep = torch.empty((N, n), dtype=torch.bool, device=dev)
    thr = int(alpha_threshold(alpha))
    for s in range(0, N, rows):
        e = min(N, s + rows)
        ids = torch.arange(s, e, dtype=torch.int64, device=dev)
        h1[s:e], word[s:e], keep[s:e] = hash_cache_chunk(codes[s:e], ids, k,
                                                         h, thr)
    nwin = N * n
    records = []

    # ---- K3 bloom_or_words: filter A (sampled) and filter B (trusted)
    filt_a = tb.bloom_build_words(h1, word, keep, pa.log2_m)
    plain_a = tb.bloom_build_words_plain(h1, word, keep, pa.log2_m)
    torch.cuda.synchronize()
    mm_a = mismatches(filt_a, plain_a)
    log(f"[kernels] bloom_or_words filter A: {mm_a} mismatching words of "
        f"{filt_a.numel()}, {int(keep.sum())} windows kept")

    # ---- K1 bloom_probe, cached entry point, all windows against A
    hits = tb.bloom_query_words(filt_a, h1, word)
    hits_plain = tb.bloom_query_words_plain(filt_a, h1, word)
    torch.cuda.synchronize()
    mm_k1 = mismatches(hits, hits_plain)
    log(f"[kernels] bloom_probe (cached words): {mm_k1} mismatches of {nwin}")
    k1_ms = cuda_ms(lambda: tb.bloom_query_words(filt_a, h1, word))
    k1_plain_ms = cuda_ms(
        lambda: tb.bloom_query_words_plain(filt_a, h1, word))
    block = u32_to_wide(h1) & ((1 << (pa.log2_m - 5)) - 1)
    k1_lib_ms = cuda_ms(lambda: filt_a[block])   # the one-call yardstick
    del block, hits_plain
    k1_bound, k1_by = bound(nwin * 9 + filt_a.numel() * 4, nwin * 4)

    # trusted windows as the main path computes them
    t_table = torch.from_numpy(coverage_thresholds(alpha, k)).to(dev)
    trusted = torch.empty_like(keep)
    for s in range(0, N, rows):
        e = min(N, s + rows)
        trusted[s:e] = trusted_mask_batch(hits[s:e], word[s:e] != 0, t_table,
                                          k, cfg.trust_threshold)
    del hits
    filt_b = tb.bloom_build_words(h1, word, trusted, pb.log2_m)
    plain_b = tb.bloom_build_words_plain(h1, word, trusted, pb.log2_m)
    torch.cuda.synchronize()
    mm_b = mismatches(filt_b, plain_b)
    log(f"[kernels] bloom_or_words filter B: {mm_b} mismatching words, "
        f"{int(trusted.sum())} windows trusted")
    scratch = torch.empty_like(filt_b)
    k3_ms = cuda_ms(
        lambda: kernels.bloom_or_words(scratch, h1, word, trusted),
        before=scratch.zero_)
    k3_plain_ms = cuda_ms(
        lambda: tb.bloom_build_words_plain(h1, word, trusted, pb.log2_m),
        reps=1)
    del scratch, plain_a, plain_b
    k3_bound, k3_by = bound(nwin * 9 + 2 * filt_b.numel() * 4, nwin * 2)
    records.append({
        "name": "bloom_or_words", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "kbbq_tpu/ops/bloom.py:164",
        "replaces_note": "XLA sort build bloom_rows_dense; no Pallas "
                         "counterpart",
        "n": nwin, "mismatches": mm_a + mm_b,
        "max_abs_err": float(min(1, mm_a + mm_b)),
        "ms": k3_ms, "kernel_ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None})

    # ---- K1 hashed entry point, on one chunk of reads (the main path
    # always holds the hash cache, so it uses the cached entry point)
    wr = min(WALK_READS, N)
    hi, lo, valid = canonical_kmers_batch(codes[:wr], k)
    got = tb.bloom_query_rows(filt_b, hi, lo, h)
    want = tb.bloom_query_rows_plain(filt_b, hi, lo, h)
    torch.cuda.synchronize()
    mm_k1h = mismatches(got, want)
    log(f"[kernels] bloom_probe (hashed): {mm_k1h} mismatches of "
        f"{got.numel()}")
    k1h_ms = cuda_ms(lambda: tb.bloom_query_rows(filt_b, hi, lo, h))
    records.insert(0, {
        "name": "bloom_probe", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "kbbq_tpu/ops/pallas_bloom.py:105",
        "n": nwin, "mismatches": mm_k1 + mm_k1h,
        "max_abs_err": float(min(1, mm_k1 + mm_k1h)),
        "ms": k1_ms, "kernel_ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib_ms,
        "hashed_entry": {"n": got.numel(), "mismatches": mm_k1h,
                         "ms": k1h_ms}})
    del hi, lo, got, want

    # ---- K2 walk_errors against its plain version on EVERY chunk of the
    # dataset with the full-size filter B (timed on the first chunk, the
    # shape the main path gives it); the plain masks feed the expected output
    quals = torch.from_numpy(arrays.quals).to(dev)
    mask = torch.from_numpy(arrays.mask).to(dev)
    rgs = torch.from_numpy(arrays.rgs.astype(np.int64)).to(dev)
    seconds = torch.from_numpy(arrays.seconds.astype(bool)).to(dev)
    num_rg = int(arrays.rgs.max(initial=0)) + 1
    cov = new_covariate_state(num_rg, L, dev)
    mm_k2 = marks_all = 0
    for s in range(0, N, rows):
        e = min(N, s + rows)
        tr0 = tb.bloom_query_words(filt_b, h1[s:e], word[s:e])
        if not torch.equal(tr0, tb.bloom_query_words_plain(
                filt_b, h1[s:e], word[s:e])):
            raise AssertionError(
                "initial trust differs between kernel and plain")
        err = infer_errors(filt_b, codes[s:e], k, h, cfg.ext_cap,
                           trusted0=tr0)
        torch.cuda.synchronize()
        t0 = time.time()
        err_plain = infer_errors_plain(filt_b, codes[s:e], k, h, cfg.ext_cap,
                                       trusted0=tr0)
        torch.cuda.synchronize()
        if s == 0:
            k2_plain_ms = (time.time() - t0) * 1e3
            marks = int(err.sum())
            outside = int((~tr0).sum())
            k2_ms = cuda_ms(lambda: infer_errors(
                filt_b, codes[:e], k, h, cfg.ext_cap, trusted0=tr0))
        mm_k2 += mismatches(err, err_plain)
        marks_all += int(err_plain.sum())
        accumulate_covariates(cov, codes[s:e], quals[s:e], mask[s:e],
                              rgs[s:e], seconds[s:e], err_plain)
    log(f"[kernels] walk_errors: {mm_k2} mismatches of {N * L} bases in {N} "
        f"reads, {marks_all} bases marked ({marks} in the {wr} reads timed)")
    # least work this data needs: every window outside the anchor is rolled
    # once (~12 integer operations), and every marked base tried 3
    # candidates with at least one probe each (~90: two fmix32 pairs, the
    # 7-bit probe word, the test).  Bytes: codes, initial trust and error
    # mask once, and of the filter only the 4-byte words those probes fetch
    # (at least 3 per marked base; never more than the filter holds)
    filter_bytes = min(filt_b.numel() * 4, marks * 3 * 4)
    k2_bound, k2_by = bound(wr * (L + n + L) + filter_bytes,
                            outside * 12 + marks * 3 * 90)

    # what the main path must write, through the plain walk
    tables = CovariateTables(
        num_rg, L, *(cov[name].cpu().numpy() for name in
                     ("cyc_total", "cyc_errors", "din_total", "din_errors")))
    recal = torch.from_numpy(build_recal_table(tables)).to(dev)
    expected = np.empty((N, L), dtype=np.int8)
    for s in range(0, N, rows):
        e = min(N, s + rows)
        expected[s:e] = apply_recal_table(
            recal, codes[s:e], quals[s:e], mask[s:e], rgs[s:e],
            seconds[s:e]).cpu().numpy()
    records.insert(1, {
        "name": "walk_errors", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "kbbq_tpu/ops/pallas_walk.py:242",
        "n": wr, "reads_checked": N, "mismatches": mm_k2,
        "max_abs_err": float(min(1, mm_k2)),
        "ms": k2_ms, "kernel_ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None})

    bad = [r["name"] for r in records if r["mismatches"]]
    if bad:
        raise AssertionError(f"kernels disagree with plain versions: {bad}")
    for r in records:
        log(f"[kernels] {r['name']}: {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']})")
    return records, expected


def phase_golden(tmp):
    from kbbq_tpu_torch.io.batcher import ReadArrays
    from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_fastq,
                                         run_pipeline)
    from kbbq_tpu_torch.utils.synth import make_dataset

    out = os.path.join(tmp, "tiny.out.fq")
    recalibrate_fastq(os.path.join(DATA, "tiny.fq"), out,
                      RecalConfig(k=16, coverage=18.0, batch_size=64))
    with open(out, "rb") as f, \
            open(os.path.join(DATA, "tiny.recal.golden.fq"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("tiny.fq output differs from the golden")
    log("[golden] tiny.fq == tiny.recal.golden.fq byte for byte")

    z = np.load(os.path.join(DATA, "midscale_golden.npz"))
    seed, gl, rl, cov, k, nrg = (int(v) for v in z["meta"])
    ds = make_dataset(genome_len=gl, read_len=rl, coverage=float(cov),
                      error_rate=0.01, seed=seed, num_rg=nrg, paired=True,
                      n_rate=0.002)
    codes = np.stack([np.asarray(c) for c in ds.codes])
    quals = np.stack([np.asarray(q).astype(np.int8) for q in ds.quals])
    arrays = ReadArrays(codes, quals, np.ones(codes.shape, bool),
                        np.asarray(ds.rgs, np.int32),
                        np.asarray(ds.seconds, bool))
    got = run_pipeline(arrays, RecalConfig(k=k, coverage=float(cov),
                                           batch_size=2048))
    if not np.array_equal(got, z["quals"]):
        raise AssertionError("midscale golden not reproduced")
    planted = np.stack(ds.true_errors)
    q_err, q_ok = float(got[planted].mean()), float(got[~planted].mean())
    if not q_err < q_ok - 1.0:
        raise AssertionError(f"mean Q at planted errors {q_err:.2f} is not "
                             f"clearly below {q_ok:.2f} elsewhere")
    log(f"[golden] mean recalibrated Q {q_err:.2f} at planted errors, "
        f"{q_ok:.2f} elsewhere")
    log(f"[golden] midscale_golden.npz reproduced exactly "
        f"({codes.shape[0]} reads)")


def phase_main_path(tmp, fastq_bytes, true_err, expected, cfg, read_len):
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.io.fastq import extract_padded_arrays, read_fastq
    from kbbq_tpu_torch.pipeline import recalibrate_fastq

    src = os.path.join(tmp, "reads.fq")
    with open(src, "wb") as f:
        f.write(fastq_bytes)
    del fastq_bytes
    out1, out2 = os.path.join(tmp, "out1.fq"), os.path.join(tmp, "out2.fq")

    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    kernels.reset_launches()
    t0 = time.time()
    info = recalibrate_fastq(src, out1, cfg, timings=timings)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    missing = [name for name, cnt in launches.items() if cnt < 1]
    if missing:
        raise AssertionError(f"main path launched no {missing}")

    fq_in, fq_out = read_fastq(src), read_fastq(out1)
    if fq_out.num_reads != info["num_reads"] or \
            fq_in.buf.shape != fq_out.buf.shape:
        raise AssertionError("output FASTQ has another layout than the input")
    is_qual = np.zeros(fq_in.buf.size, dtype=bool)
    for s in range(0, fq_in.num_reads, 65536):
        e = min(fq_in.num_reads, s + 65536)
        is_qual[(fq_in.qual_starts[s:e, None]
                 + np.arange(read_len)[None, :]).ravel()] = True
    if ((fq_in.buf != fq_out.buf) & ~is_qual).any():
        raise AssertionError("names or sequences changed")
    qbytes = fq_out.buf[is_qual]
    if int(qbytes.min()) < 34 or int(qbytes.max()) > 126:
        raise AssertionError("output quality outside chr 34..126")
    _, new_q, _, _ = extract_padded_arrays(fq_out)
    # every quality written equals what the plain versions of the kernels
    # give on the same dataset (phase_kernels)
    diff = int((new_q != expected).sum())
    if new_q.shape != expected.shape or diff:
        raise AssertionError(f"{diff} output qualities differ from the "
                             f"plain-version pipeline's")
    # make_arrays_fast plants its errors independently of every covariate,
    # so no covariate model can tell them apart: what the output must get
    # right is the CALIBRATION, the errors its qualities predict against the
    # errors planted (phase_golden checks the separation, on data whose
    # errors do follow the reported quality)
    q_err = float(new_q[true_err].mean())
    q_ok = float(new_q[~true_err].mean())
    predicted = float(np.power(10.0, -new_q.astype(np.float64) / 10.0).sum())
    planted = int(true_err.sum())
    if not 0.75 <= predicted / planted <= 1.35:
        raise AssertionError(f"output qualities predict {predicted:.0f} "
                             f"errors, {planted} were planted")
    del fq_in, fq_out, is_qual, new_q

    recalibrate_fastq(src, out2, cfg)
    with open(out1, "rb") as f, open(out2, "rb") as g:
        if f.read() != g.read():
            raise AssertionError("second run gave other bytes")

    result = {"reads": info["num_reads"], "bases": info["total_bases"],
              "wall_s": wall, "reads_per_s": info["num_reads"] / wall,
              "timings": timings, "launches": launches,
              "peak_device_bytes": peak,
              "mean_q_at_planted_errors": q_err, "mean_q_elsewhere": q_ok,
              "errors_predicted_by_quals": predicted,
              "errors_planted": planted,
              "quals_differing_from_plain_pipeline": diff,
              "deterministic": True, "card": smi_line()}
    log("[main_path] " + json.dumps(result))
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=FULL_READS,
                    help="reads of the main-path dataset (default: full size)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1

    from kbbq_tpu_torch.pipeline import RecalConfig
    from kbbq_tpu_torch.utils.synth import (arrays_to_fastq_bytes,
                                            make_arrays_fast)

    t_start = time.time()
    phase_device()

    read_len = 150
    genome_len = max(10_000, int(4_600_000 * args.reads / FULL_READS))
    arrays, true_err = make_arrays_fast(
        genome_len=genome_len, read_len=read_len, num_reads=args.reads,
        error_rate=0.005, seed=args.seed, paired=True)
    cfg = RecalConfig(k=32, coverage=50.0, batch_size=8192)
    log(f"[data] {args.reads} reads x {read_len} from a {genome_len} bp "
        f"genome, seed {args.seed} ({time.time() - t_start:.0f} s)")

    records, expected = phase_kernels(arrays, cfg)
    torch.cuda.empty_cache()
    fastq_bytes = arrays_to_fastq_bytes(arrays)
    del arrays

    tmp = tempfile.mkdtemp(prefix="kbbq_smoke_")
    try:
        phase_golden(tmp)
        launches = phase_main_path(tmp, fastq_bytes, true_err, expected, cfg,
                                   read_len)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for r in records:
        r["launches"] = launches[r["name"]]
    log(f"[done] {time.time() - t_start:.0f} s in all")
    print(json.dumps({"kernels": records}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

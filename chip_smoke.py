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
kernel entry point: launches on the main path, mismatches against the plain
version, times in ms, the roofline bound), the card's name and power limit
as nvidia-smi gives them, and {"ok": true, "device": {...}}.  In every entry
"ms" is the time between two CUDA events around one call of the entry
point's dispatcher, host enqueue work included; "graph_ms", where present,
is the card's time for one launch out of a CUDA graph of 20.

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
# the walk on reads whose two directions commit into one word of the packed
# working copy: (read length, k, extension cap), and launches of each
TWO_SIDED_SHAPES = [(36, 8, 8), (44, 16, 16), (40, 12, 6)]
TWO_SIDED_LAUNCHES = 20
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


def cuda_graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one fn() for kernels of a few microseconds: `launches`
    calls are captured into one CUDA graph and the graph's replay is timed,
    so the card never waits for the host to enqueue the next launch (which
    is what an event pair around a single short launch mostly measures)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps=reps) / launches


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


def two_sided_walks(dev, num_hashes):
    """walk_errors against its plain version on reads with a short anchor
    and errors on both sides of it inside one 32-base word: the two
    directions of such a read run in different warps and commit into the
    same 64-bit word of the read's packed working copy.  A commit that
    rewrote more than its own base would show only when two commits meet in
    time, so every shape is launched TWO_SIDED_LAUNCHES times.  Returns
    (mismatches over all launches, reads corrected on both sides)."""
    from kbbq_tpu_torch.ops import bloom as tb
    from kbbq_tpu_torch.ops.hash_cache import hash_cache_build
    from kbbq_tpu_torch.ops.inference import infer_errors, infer_errors_plain
    from kbbq_tpu_torch.utils.synth import make_two_sided_reads

    mm = both = 0
    for L, k, W in TWO_SIDED_SHAPES:
        clean, codes, left, right = make_two_sided_reads(
            WALK_READS, L, k, genome_len=5000, seed=L * k)
        # the filter holds every k-mer of the error-free reads
        *_, filt = hash_cache_build(torch.from_numpy(clean).to(dev), 0, k,
                                    num_hashes, 0xFFFFFFFF, 24)
        codes = torch.from_numpy(codes).to(dev)
        h1, word, _, _ = hash_cache_build(codes, 0, k, num_hashes, 0, 24)
        tr0 = tb.bloom_query_words(filt, h1, word)
        want = infer_errors_plain(filt, codes, k, num_hashes, W, trusted0=tr0)
        both += int((want[:, left[0]:left[1]].any(dim=1)
                     & want[:, right[0]:right[1]].any(dim=1)).sum())
        for _ in range(TWO_SIDED_LAUNCHES):
            mm += mismatches(infer_errors(filt, codes, k, num_hashes, W,
                                          trusted0=tr0), want)
    return mm, both


def phase_kernels(arrays, cfg):
    """Each kernel against its plain version on the card, on the main
    path's own state: the hash cache of all windows of the dataset and the
    filters built from it.  The walk's plain version runs over EVERY chunk,
    and its error masks go on through the histogram, the delta math and the
    gather, so the phase also yields the qualities that the main path must
    write.  Returns the per-kernel records (without the main path's launch
    counts) and those qualities, int8 [N, L] on the host."""
    from kbbq_tpu_torch.ops import bloom as tb
    from kbbq_tpu_torch.ops.hash_cache import (hash_cache_build,
                                               hash_cache_chunk)
    from kbbq_tpu_torch.ops.inference import infer_errors, infer_errors_plain
    from kbbq_tpu_torch.ops.kmers import canonical_kmers_batch, u32_to_wide
    from kbbq_tpu_torch.ops.trusted import trusted_mask_batch
    from kbbq_tpu_torch.oracle import (alpha_threshold, bloom_params_for,
                                       coverage_thresholds)
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.constants import DEFAULT_EXT_CAP
    from kbbq_tpu_torch.ops.covariate import (accumulate_covariates,
                                              new_covariate_state)
    from kbbq_tpu_torch.ops.recal import apply_recal_table
    from kbbq_tpu_torch.oracle.covariate import CovariateTables
    from kbbq_tpu_torch.oracle.gatk import build_recal_table
    from kbbq_tpu_torch.pipeline.resident import DEFAULT_CHUNK_ROWS

    dev = torch.device(DEVICE)
    k, h = cfg.k, cfg.num_hashes
    N, L = arrays.codes.shape
    n = L - k + 1
    rows = DEFAULT_CHUNK_ROWS
    alpha, coverage = cfg.resolve_alpha(N * L)
    pa, pb = bloom_params_for(cfg, N * n, alpha, coverage)
    log(f"[kernels] {N} reads x {L}, {N * n} windows, filter A 2^{pa.log2_m}"
        f" B 2^{pb.log2_m} bits, chunk {rows} rows")
    nwin = N * n
    records = []

    def record(name, entry, replaces, mm, ms, plain_ms, bnd, lib_ms=None,
               **more):
        records.append({
            "name": name, "entry": entry, "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": replaces, "mismatches": mm,
            "max_abs_err": float(min(1, mm)), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
            **more})

    # the floor under every launch: a kernel that does nothing
    empty_ms = cuda_graph_ms(kernels.empty_launch)
    empty_events_ms = cuda_ms(kernels.empty_launch, reps=21)
    log(f"[kernels] empty launch: {empty_ms * 1e3:.2f} us on the card, "
        f"{empty_events_ms * 1e3:.2f} us between two events around it")

    codes = torch.from_numpy(arrays.codes).to(dev)
    thr = int(alpha_threshold(alpha))

    # ---- K3 bloom_or_words, fused entry point: hash cache + filter A of the
    # whole dataset in one launch, against the plain hash pass + plain build
    def plain_pass1():
        p1 = torch.empty((N, n), dtype=torch.int32, device=dev)
        pw = torch.empty_like(p1)
        pk = torch.empty((N, n), dtype=torch.bool, device=dev)
        for s in range(0, N, rows):
            e = min(N, s + rows)
            ids = torch.arange(s, e, dtype=torch.int64, device=dev)
            p1[s:e], pw[s:e], pk[s:e] = hash_cache_chunk(codes[s:e], ids, k,
                                                         h, thr)
        return p1, pw, pk, tb.bloom_build_words_plain(p1, pw, pk, pa.log2_m)

    plain_pass1()                                   # warm the allocator
    torch.cuda.synchronize()
    t0 = time.time()
    p1, pw, pk, plain_a = plain_pass1()
    torch.cuda.synchronize()
    fused_plain_ms = (time.time() - t0) * 1e3
    h1, word, keep, filt_a = hash_cache_build(codes, 0, k, h, thr, pa.log2_m)
    torch.cuda.synchronize()
    mm_f = {"h1": mismatches(h1, p1), "word": mismatches(word, pw),
            "keep": mismatches(keep, pk), "filter": mismatches(filt_a,
                                                               plain_a)}
    kept_a = int(keep.sum())
    log(f"[kernels] bloom_or_words fused (hash cache + filter A): mismatches "
        f"{mm_f} over {nwin} windows / {filt_a.numel()} words, {kept_a} "
        f"windows kept")
    del p1, pw, pk, plain_a
    scratch = torch.empty_like(filt_a)
    fused_ms = cuda_ms(
        lambda: kernels.hash_build(codes, scratch, 0, k, h, thr),
        before=scratch.zero_)
    # ~150 integer operations per window: k-mer roll, two fmix32 pairs, the
    # probe word, the sampling hash
    record("bloom_or_words.hash_build", "hash_build",
           "kbbq_tpu/ops/bloom.py:164 + kbbq_tpu/pipeline/resident.py:330",
           sum(mm_f.values()), fused_ms, fused_plain_ms,
           bound(N * L + nwin * 9 + 2 * filt_a.numel() * 4, nwin * 150),
           n=nwin, kept=kept_a,
           replaces_note="XLA sort build bloom_rows_dense and the XLA hash "
                         "pass _pass1_kmers_slice; no Pallas counterpart")

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
    k1_bound = bound(nwin * 9 + filt_a.numel() * 4, nwin * 4)

    # trusted windows as the main path computes them
    t_table = torch.from_numpy(coverage_thresholds(alpha, k)).to(dev)
    trusted = torch.empty_like(keep)
    for s in range(0, N, rows):
        e = min(N, s + rows)
        trusted[s:e] = trusted_mask_batch(hits[s:e], word[s:e] != 0, t_table,
                                          k, cfg.trust_threshold)
    del hits, keep

    # ---- K3 bloom_or_words, cached entry point: filter B from the trusted
    # windows of the cache
    filt_b = tb.bloom_build_words(h1, word, trusted, pb.log2_m)
    plain_b = tb.bloom_build_words_plain(h1, word, trusted, pb.log2_m)
    torch.cuda.synchronize()
    mm_b = mismatches(filt_b, plain_b)
    kept_b = int(trusted.sum())
    log(f"[kernels] bloom_or_words filter B: {mm_b} mismatching words, "
        f"{kept_b} windows trusted")
    del plain_b
    k3_ms = cuda_ms(
        lambda: kernels.bloom_or_words(scratch, h1, word, trusted),
        before=scratch.zero_)
    k3_plain_ms = cuda_ms(
        lambda: tb.bloom_build_words_plain(h1, word, trusted, pb.log2_m),
        reps=1)
    del scratch
    record("bloom_or_words", "bloom_or_words", "kbbq_tpu/ops/bloom.py:164",
           mm_b, k3_ms, k3_plain_ms,
           bound(nwin * 9 + 2 * filt_b.numel() * 4, nwin * 2),
           n=nwin, kept=kept_b,
           replaces_note="XLA sort build bloom_rows_dense; no Pallas "
                         "counterpart")
    del trusted

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
    k1h_plain_ms = cuda_ms(
        lambda: tb.bloom_query_rows_plain(filt_b, hi, lo, h))
    record("bloom_probe", "bloom_probe_words",
           "kbbq_tpu/ops/pallas_bloom.py:105", mm_k1, k1_ms, k1_plain_ms,
           k1_bound, k1_lib_ms, n=nwin)
    # ~90 integer operations per k-mer: two fmix32 pairs, the probe word,
    # the test.  The main path holds the hash cache, so it never comes here
    record("bloom_probe.hashed", "bloom_probe_hashed",
           "kbbq_tpu/ops/pallas_bloom.py:105", mm_k1h, k1h_ms, k1h_plain_ms,
           bound(got.numel() * 9 + filt_b.numel() * 4, got.numel() * 90),
           n=got.numel(), on_main_path=False)
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
    tr0_all = tb.bloom_query_words(filt_b, h1, word)
    if not torch.equal(tr0_all, tb.bloom_query_words_plain(filt_b, h1,
                                                           word)):
        raise AssertionError("initial trust differs between kernel and plain")
    del h1, word
    mm_k2 = marks_all = 0
    for s in range(0, N, rows):
        e = min(N, s + rows)
        tr0 = tr0_all[s:e]
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
            k2_graph_ms = cuda_graph_ms(lambda: kernels.walk_errors(
                codes[:e], tr0, filt_b, k,
                min(cfg.ext_cap or DEFAULT_EXT_CAP, k), h))
            k2_ms = cuda_ms(lambda: infer_errors(
                filt_b, codes[:e], k, h, cfg.ext_cap, trusted0=tr0), reps=9)
        mm_k2 += mismatches(err, err_plain)
        marks_all += int(err_plain.sum())
        accumulate_covariates(cov, codes[s:e], quals[s:e], mask[s:e],
                              rgs[s:e], seconds[s:e], err_plain)
    log(f"[kernels] walk_errors: {mm_k2} mismatches of {N * L} bases in {N} "
        f"reads, {marks_all} bases marked ({marks} in the {wr} reads timed)")
    # the narrow-load path: an odd number of reads from a base pointer that
    # is one read (L, and n, bytes: not a multiple of 16) into the tensors
    odd = min(N - 1, 60001) | 1
    if 1 + odd > N:
        odd -= 2
    c_odd, t_odd = codes[1:1 + odd], tr0_all[1:1 + odd]
    mm_odd = mismatches(
        infer_errors(filt_b, c_odd, k, h, cfg.ext_cap, trusted0=t_odd),
        infer_errors_plain(filt_b, c_odd, k, h, cfg.ext_cap, trusted0=t_odd))
    log(f"[kernels] walk_errors, misaligned ({odd} reads from row 1, base "
        f"pointers at {c_odd.data_ptr() % 16} and {t_odd.data_ptr() % 16} "
        f"mod 16): {mm_odd} mismatches")
    del tr0_all
    mm_two, both = two_sided_walks(dev, h)
    log(f"[kernels] walk_errors, both directions committing into one word "
        f"(L, k, W = {TWO_SIDED_SHAPES}, {WALK_READS} reads each, {both} "
        f"corrected on both sides, {TWO_SIDED_LAUNCHES} launches each): "
        f"{mm_two} mismatches")
    # least work this data needs: every window outside the anchor is rolled
    # once (~12 integer operations), and every marked base tried 3
    # candidates with at least one probe each (~90: two fmix32 pairs, the
    # 7-bit probe word, the test).  Bytes: codes, initial trust and error
    # mask once, and of the filter only the 4-byte words those probes fetch
    # (at least 3 per marked base; never more than the filter holds)
    filter_bytes = min(filt_b.numel() * 4, marks * 3 * 4)
    k2_bound = bound(wr * (L + n + L) + filter_bytes,
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
    record("walk_errors", "walk_errors", "kbbq_tpu/ops/pallas_walk.py:242",
           mm_k2 + mm_odd + mm_two, k2_ms, k2_plain_ms, k2_bound, n=wr,
           graph_ms=k2_graph_ms, reads_checked=N, marks=marks,
           misaligned_reads=odd, two_sided_reads=both,
           two_sided_launches=TWO_SIDED_LAUNCHES * len(TWO_SIDED_SHAPES),
           empty_launch_graph_ms=empty_ms, empty_launch_ms=empty_events_ms)

    bad = [r["name"] for r in records if r["mismatches"]]
    if bad:
        raise AssertionError(f"kernels disagree with plain versions: {bad}")
    order = ["bloom_probe", "bloom_probe.hashed", "walk_errors",
             "bloom_or_words", "bloom_or_words.hash_build"]
    records.sort(key=lambda r: order.index(r["name"]))
    for r in records:
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
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
    from kbbq_tpu_torch.pipeline.resident import DEFAULT_CHUNK_ROWS

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
    by_entry = dict(kernels.ENTRY_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # pass 1 fused build, pass 2 cached build; one probe each in passes 2
    # and 3; one walk per chunk of reads
    want = {"bloom_probe": 2, "bloom_or_words": 2,
            "walk_errors": -(-info["num_reads"] // DEFAULT_CHUNK_ROWS)}
    if launches != want or by_entry["hash_build"] != 1:
        raise AssertionError(f"main path launched {launches} ({by_entry}), "
                             f"expected {want}")

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
              "launches_by_entry": by_entry,
              "peak_device_bytes": peak,
              "mean_q_at_planted_errors": q_err, "mean_q_elsewhere": q_ok,
              "errors_predicted_by_quals": predicted,
              "errors_planted": planted,
              "quals_differing_from_plain_pipeline": diff,
              "deterministic": True, "card": smi_line()}
    log("[main_path] " + json.dumps(result))
    return by_entry


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
        r["launches"] = launches[r["entry"]]
    log(f"[done] {time.time() - t_start:.0f} s in all")
    print(json.dumps({"kernels": records}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

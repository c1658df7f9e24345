#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kbbq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full size, needs one CUDA card and nvcc
    python3 chip_smoke.py --reads N  # a smaller main-path dataset (debugging)

Builds the CUDA kernels and the host IO codec from kbbq_tpu_torch/csrc (one
nvcc and one g++, started together), holds each kernel entry point against
its plain PyTorch version on the card at the shapes its path gives it, runs
the two golden checks and the report round trip (``report_out`` then
``apply_report``) on the card, then drives the port's two FASTQ paths at the
size of BASELINE.json config 2 (E. coli-like 4.6 Mb genome, 2x150 bp, ~50x,
1,533,333 reads made from a seed): the resident main path
(``recalibrate_fastq``) and the streamed path
(``recalibrate_fastq_streaming``, 12 windows), whose bytes must be equal, with
the launches of each asserted by entry point.  Beside them: the native FASTQ
codec against its NumPy versions on the same file, and the checkpoints
(resume after pass 3 and inside pass 4, in memory, the fingerprint guard) on
the midscale golden.  Then the BAM routes at the size of BASELINE.json
config 3: the same reads written as a coordinate-sorted BGZF BAM (three read
groups, half the records on the reverse strand, ~1 % secondary and
supplementary copies), decoded back exactly, recalibrated by
``recalibrate_bam(set_oq=True)`` (qualities equal ``run_pipeline``'s on the
same arrays; every other byte, the OQ tags and the pass-through records as
required; a second run gives the same bytes), by
``recalibrate_bam_streaming`` (the same bytes), and again with
``use_oq=True`` from that output (the same qualities); launches asserted by
entry point on both routes, the native BAM codec timed against its NumPy
versions.  Any failed phase raises, so the exit code is non-zero; without a
CUDA device the script exits 1 at once and prints no result.

Output, last three lines: a JSON object {"kernels": [...]} (one entry per
kernel entry point: launches on its path (``launches``: the resident main
path's count, the streamed path's for the hash-only entry, whose only path
it is; ``launches_streamed``, ``launches_bam`` and ``launches_bam_streamed``
beside it in every entry), mismatches against the plain
version, times in ms, the roofline bound; the probe's entries also
"bound_l2_ms", the time its sector traffic took in this run when every
filter read hit in L2, and the cached word test "ms_by_log2_m", its time
against filters of a quarter, one and four times the main path's size, the
first of which is that reading), the card's name and power limit
as nvidia-smi gives them, and {"ok": true, "device": {...}}.  In every entry
"ms" is the time between two CUDA events around one call of the entry
point's dispatcher, host enqueue work included; "graph_ms", where present,
is the card's time for one launch out of a CUDA graph of several.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")

# NVIDIA H100 SXM data sheet: device memory rate, and the float32 rate
# outside the tensor cores, taken as the ceiling for the kernels' 32/64-bit
# integer operations (the integer pipes are no faster)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# a random 4-byte read of the filter moves one sector of this size through L2
L2_SECTOR = 32

FULL_READS = 1_533_333
WALK_READS = 65_536          # rows of the walk kernel's check = one chunk
# the walk on reads whose two directions commit into one word of the packed
# working copy: (read length, k, extension cap), and launches of each
TWO_SIDED_SHAPES = [(36, 8, 8), (44, 16, 16), (40, 12, 6)]
TWO_SIDED_LAUNCHES = 20
# the fused trust probe on narrow reads: (read length, k, trust threshold)
NARROW_TRUST_SHAPES = [(36, 8, None), (36, 8, 5), (44, 16, 9)]
KERNEL_SOURCE = "kbbq_tpu_torch/csrc/kbbq_kernels.cu"
CODEC_SOURCE = "kbbq_tpu_torch/csrc/kbbq_io.cc"
STREAM_WINDOW = 131_072      # reads per window of the streamed path
CKPT_CHUNK = 4096            # reads per chunk of the checkpoint runs
BAM_EXTRA_SHARE = 0.01       # primaries followed by a secondary/supplementary
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
    from kbbq_tpu_torch.io import native_lib
    log(f"[device] {smi_line()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([kernels._find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout
    log("[device] nvcc " + " ".join(
        ln.strip() for ln in nvcc.splitlines() if "release" in ln))
    gxx = subprocess.run([native_lib.CXX, "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    zlib_h = subprocess.run([native_lib.CXX, "-E", "-x", "c++", "-"],
                            input="#include <zlib.h>\n", capture_output=True,
                            text=True).returncode == 0
    log(f"[device] {gxx}; zlib.h {'found' if zlib_h else 'MISSING'}")
    # always from the sources of this checkout: both builds at once
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(kernels.library), ex.submit(native_lib.library)]:
            f.result()
    log(f"[device] built {KERNEL_SOURCE} in {kernels.build_seconds:.1f} s "
        f"and {CODEC_SOURCE} in {native_lib.build_seconds:.1f} s, together")
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


def narrow_trust(dev, num_hashes):
    """bloom_probe_trust against its plain version on short reads with a
    short k (several reads per 32 windows of a warp, masks of one or two
    words) and with a trust threshold below k.  Filter A holds a 30 % sample
    of the reads' own windows.  Returns (mismatches, windows trusted,
    windows checked)."""
    from kbbq_tpu_torch.ops.hash_cache import hash_cache_build
    from kbbq_tpu_torch.ops.trusted import (trusted_from_cache,
                                            trusted_from_cache_plain)
    from kbbq_tpu_torch.oracle import alpha_threshold, coverage_thresholds
    from kbbq_tpu_torch.utils.synth import make_two_sided_reads

    mm = trusted = windows = 0
    for L, k, T in NARROW_TRUST_SHAPES:
        _, codes, _, _ = make_two_sided_reads(WALK_READS + 1, L, k,
                                              genome_len=5000, seed=L + k)
        h1, word, _, filt = hash_cache_build(
            torch.from_numpy(codes).to(dev), 0, k, num_hashes,
            int(alpha_threshold(0.3)), 22)
        t = torch.from_numpy(coverage_thresholds(0.3, k)).to(dev)
        got = trusted_from_cache(filt, h1, word, t, k, T)
        want = trusted_from_cache_plain(filt, h1, word, t, k, T)
        mm += mismatches(got, want)
        trusted += int(want.sum())
        windows += want.numel()
    return mm, trusted, windows


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
                                               hash_cache_chunk,
                                               hash_windows_plain)
    from kbbq_tpu_torch.ops.inference import infer_errors, infer_errors_plain
    from kbbq_tpu_torch.ops.kmers import canonical_kmers_batch, u32_to_wide
    from kbbq_tpu_torch.ops.trusted import (trusted_from_cache,
                                            trusted_from_cache_plain)
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
    # ---- the fused entry point's hash-only mode (passes 2 and 3 of the
    # streamed path) on every read, against the plain hash pass
    ho_h1, ho_word = kernels.hash_only(codes, k, h)
    torch.cuda.synchronize()
    mm_ho = mismatches(ho_h1, p1) + mismatches(ho_word, pw)
    del ho_h1, ho_word, p1, pw, pk, plain_a
    # timed at the streamed path's shape: one window of STREAM_WINDOW reads
    wr_s = min(STREAM_WINDOW, N)
    cw = codes[:wr_s]
    ho_ms = cuda_ms(lambda: kernels.hash_only(cw, k, h))
    ho_graph_ms = cuda_graph_ms(lambda: kernels.hash_only(cw, k, h),
                                launches=5)
    hash_windows_plain(cw, k, h)                    # warm the allocator
    torch.cuda.synchronize()
    t0 = time.time()
    hash_windows_plain(cw, k, h)
    torch.cuda.synchronize()
    ho_plain_ms = (time.time() - t0) * 1e3
    nwin_s = wr_s * n
    log(f"[kernels] hash-only mode: {mm_ho} mismatches over {nwin} windows "
        f"(h1 and word against the plain hash pass); one window of {wr_s} "
        f"reads {ho_ms:.4f} ms ({ho_graph_ms:.4f} from a graph)")
    # ~140 integer operations per window: the fused build's less the
    # sampling hash; bytes: 1 B per base read, 8 B per window written
    record("bloom_or_words.hash_only", "hash_only",
           "kbbq_tpu/pipeline/stream_resident.py:108 + "
           "kbbq_tpu/pipeline/recalibrate.py:95",
           mm_ho, ho_ms, ho_plain_ms,
           bound(wr_s * L + nwin_s * 8, nwin_s * 140), n=nwin_s,
           graph_ms=ho_graph_ms, windows_checked=nwin, path="streamed",
           replaces_note="the XLA hash pass inside _p2_window and "
                         "_step_trusted; no Pallas counterpart")
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
    # the same windows against filters a quarter and four times the size,
    # built from the same cache: the smaller sits in L2 whatever the policy,
    # the larger cannot
    k1_by_size = {}
    for log2_m in (pa.log2_m - 2, pa.log2_m, pa.log2_m + 2):
        f = filt_a if log2_m == pa.log2_m else \
            tb.bloom_build_words(h1, word, keep, log2_m)
        mm_k1 += mismatches(tb.bloom_query_words(f, h1, word),
                            tb.bloom_query_words_plain(f, h1, word))
        k1_by_size[str(log2_m)] = cuda_ms(
            lambda: tb.bloom_query_words(f, h1, word))
        del f
    log(f"[kernels] bloom_probe by filter size (log2 bits: ms): "
        f"{k1_by_size}, {mm_k1} mismatches in all")
    # second bound, measured: the same windows through L2 (a sector each for
    # the filter, the streams once) with no filter read missing, which is the
    # reading against the quarter-size filter; and the rate that makes
    k1_l2_ms = k1_by_size[str(pa.log2_m - 2)]
    l2_rate = nwin * (L2_SECTOR + 9) / (k1_l2_ms * 1e-3)
    log(f"[kernels] bloom_probe with every filter read a hit in L2: "
        f"{k1_l2_ms} ms, {l2_rate:.4g} B/s of sectors")
    # incongruent pointers: the flat planes from element 1 (4 bytes past a
    # 16-byte boundary), a count that is no multiple of 4, into an output
    # from byte 1 (wide stores) and into a fresh one (byte stores)
    m_odd = min(nwin - 1, 40_000_003)
    m_odd -= m_odd % 4 == 0
    h1_odd, w_odd = h1.reshape(-1)[1:1 + m_odd], word.reshape(-1)[1:1 + m_odd]
    want_odd = tb.bloom_query_words_plain(filt_a, h1_odd, w_odd)
    o_odd = torch.zeros(m_odd + 1, dtype=torch.bool, device=dev)
    kernels.bloom_probe_words(filt_a, h1_odd, w_odd, out=o_odd[1:])
    mm_k1_odd = mismatches(o_odd[1:], want_odd) + mismatches(
        tb.bloom_query_words(filt_a, h1_odd, w_odd), want_odd)
    log(f"[kernels] bloom_probe, misaligned ({m_odd} windows from element 1, "
        f"base pointers at {h1_odd.data_ptr() % 16} and "
        f"{o_odd[1:].data_ptr() % 16} mod 16): {mm_k1_odd} mismatches")
    del h1_odd, w_odd, want_odd, o_odd, hits

    # ---- K1 fused entry point: probe A + coverage rule -> trusted windows,
    # one launch for the whole dataset, against the plain version (the
    # cached word test, then the rule, by chunks of rows)
    t_table = torch.from_numpy(
        coverage_thresholds(alpha, k).astype(np.int32)).to(dev)
    T = cfg.trust_threshold
    trusted_from_cache_plain(filt_a, h1[:rows], word[:rows], t_table, k, T)
    torch.cuda.synchronize()                        # allocator warm
    t0 = time.time()
    trusted_plain = trusted_from_cache_plain(filt_a, h1, word, t_table, k, T,
                                             chunk_rows=rows)
    torch.cuda.synchronize()
    k1t_plain_ms = (time.time() - t0) * 1e3
    trusted = trusted_from_cache(filt_a, h1, word, t_table, k, T)
    torch.cuda.synchronize()
    mm_k1t = mismatches(trusted, trusted_plain)
    log(f"[kernels] bloom_probe_trust: {mm_k1t} mismatches of {nwin}, "
        f"{int(trusted.sum())} windows trusted")
    # a trust threshold below k, at the main path's shape
    mm_k1t_low = mismatches(
        trusted_from_cache(filt_a, h1, word, t_table, k, k - 12,
                           out=trusted_plain),
        trusted_from_cache_plain(filt_a, h1, word, t_table, k, k - 12,
                                 chunk_rows=rows))
    mm_narrow, narrow_trusted, narrow_windows = narrow_trust(dev, h)
    log(f"[kernels] bloom_probe_trust, T = k - 12: {mm_k1t_low} mismatches; "
        f"narrow reads (L, k, T = {NARROW_TRUST_SHAPES}, {WALK_READS + 1} "
        f"reads each): {mm_narrow} mismatches, {narrow_trusted} of "
        f"{narrow_windows} windows trusted")
    k1t_ms = cuda_ms(lambda: trusted_from_cache(filt_a, h1, word, t_table, k,
                                                T, out=trusted_plain))
    k1t_graph_ms = cuda_graph_ms(lambda: kernels.bloom_probe_trust(
        filt_a, h1, word, t_table, k, k if T is None else T,
        out=trusted_plain), launches=5)
    del trusted_plain, keep
    # ~14 integer operations per window: the test, two ballots, two counts
    # over the hit and valid masks, the table, one count over the covered mask
    record("bloom_probe.trust", "bloom_probe_trust",
           "kbbq_tpu/pipeline/resident.py:404 + kbbq_tpu/ops/trusted.py:57",
           mm_k1t + mm_k1t_low + mm_narrow, k1t_ms, k1t_plain_ms,
           bound(nwin * 9 + filt_a.numel() * 4, nwin * 14), n=nwin,
           bound_l2_ms=k1_l2_ms, graph_ms=k1t_graph_ms,
           trusted=int(trusted.sum()),
           narrow_windows=narrow_windows,
           replaces_note="the XLA body of _pass2_dense_cached (cached word "
                         "test) and trusted_mask_batch; no Pallas "
                         "counterpart")

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
    k1h_graph_ms = cuda_graph_ms(
        lambda: kernels.bloom_probe_hashed(filt_b, hi, lo, h))
    record("bloom_probe", "bloom_probe_words",
           "kbbq_tpu/ops/pallas_bloom.py:105", mm_k1 + mm_k1_odd, k1_ms,
           k1_plain_ms, k1_bound, k1_lib_ms, n=nwin, bound_l2_ms=k1_l2_ms,
           l2_bytes_per_s_measured=l2_rate, ms_by_log2_m=k1_by_size,
           misaligned_windows=m_odd)
    # ~90 integer operations per k-mer: two fmix32 pairs, the probe word,
    # the test.  The main path holds the hash cache, so it never comes here
    record("bloom_probe.hashed", "bloom_probe_hashed",
           "kbbq_tpu/ops/pallas_bloom.py:105", mm_k1h, k1h_ms, k1h_plain_ms,
           bound(got.numel() * 9 + filt_b.numel() * 4, got.numel() * 90),
           n=got.numel(), graph_ms=k1h_graph_ms, on_main_path=False)
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
    order = ["bloom_probe", "bloom_probe.hashed", "bloom_probe.trust",
             "walk_errors", "bloom_or_words", "bloom_or_words.hash_build",
             "bloom_or_words.hash_only"]
    records.sort(key=lambda r: order.index(r["name"]))
    for r in records:
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return records, expected


def midscale_dataset():
    """The dataset of tests/data/midscale_golden.npz, made anew from its
    seed -> (dataset, k, coverage, the golden qualities)."""
    from kbbq_tpu_torch.utils.synth import make_dataset
    z = np.load(os.path.join(DATA, "midscale_golden.npz"))
    seed, gl, rl, cov, k, nrg = (int(v) for v in z["meta"])
    ds = make_dataset(genome_len=gl, read_len=rl, coverage=float(cov),
                      error_rate=0.01, seed=seed, num_rg=nrg, paired=True,
                      n_rate=0.002)
    return ds, k, float(cov), z["quals"]


def phase_golden(tmp):
    from kbbq_tpu_torch.io.batcher import ReadArrays
    from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_fastq,
                                         run_pipeline)

    out = os.path.join(tmp, "tiny.out.fq")
    recalibrate_fastq(os.path.join(DATA, "tiny.fq"), out,
                      RecalConfig(k=16, coverage=18.0, batch_size=64))
    with open(out, "rb") as f, \
            open(os.path.join(DATA, "tiny.recal.golden.fq"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("tiny.fq output differs from the golden")
    log("[golden] tiny.fq == tiny.recal.golden.fq byte for byte")

    ds, k, cov, golden = midscale_dataset()
    codes = np.stack([np.asarray(c) for c in ds.codes])
    quals = np.stack([np.asarray(q).astype(np.int8) for q in ds.quals])
    arrays = ReadArrays(codes, quals, np.ones(codes.shape, bool),
                        np.asarray(ds.rgs, np.int32),
                        np.asarray(ds.seconds, bool))
    got = run_pipeline(arrays, RecalConfig(k=k, coverage=cov,
                                           batch_size=2048))
    if not np.array_equal(got, golden):
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


def phase_report(tmp):
    """Report interop on the card, on the midscale golden data:
    ``report_out`` (the full pipeline, and the GATKReport of its covariate
    tables) then ``apply_report`` (pass 4 only, from that report) must write
    the same bytes, and the second run must launch no kernel."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_fastq
    from kbbq_tpu_torch.utils.synth import to_fastq_bytes

    ds, k, cov, _ = midscale_dataset()
    src = os.path.join(tmp, "midscale.fq")
    with open(src, "wb") as f:
        f.write(to_fastq_bytes(ds))
    cfg = RecalConfig(k=k, coverage=cov)
    direct, applied = (os.path.join(tmp, n) for n in ("direct.fq",
                                                      "applied.fq"))
    report = os.path.join(tmp, "recal.report")
    info = recalibrate_fastq(src, direct, cfg, report_out=report)
    kernels.reset_launches()
    recalibrate_fastq(src, applied, cfg, apply_report=report)
    torch.cuda.synchronize()
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"apply_report launched kernels: "
                             f"{kernels.LAUNCHES}")
    with open(direct, "rb") as f, open(applied, "rb") as g:
        a, b = f.read(), g.read()
    if a != b or not a:
        raise AssertionError("apply_report wrote other bytes than the run "
                             "that wrote the report")
    log(f"[report] report_out then apply_report: {info['num_reads']} reads, "
        f"{len(a)} output bytes equal, report of "
        f"{os.path.getsize(report)} bytes, apply run launched no kernel")


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

    timings: dict = {}
    kernels.reset_launches()
    t0 = time.time()
    info = recalibrate_fastq(src, out1, cfg, timings=timings)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    by_entry = dict(kernels.ENTRY_LAUNCHES)
    # the resident pipeline records the peak of every stage by itself
    peaks = {name[:-len("_peak_bytes")]: timings.pop(name)
             for name in sorted(timings) if name.endswith("_peak_bytes")}
    peak = max(peaks.values())
    log("[main_path] peak device bytes by stage: " + json.dumps(peaks))
    # pass 1 fused build; pass 2 fused trust probe and cached build; pass 3
    # one probe and one walk per chunk of reads
    chunks = -(-info["num_reads"] // DEFAULT_CHUNK_ROWS)
    want = {"bloom_probe_trust": 1, "bloom_probe_words": 1,
            "bloom_probe_hashed": 0, "hash_build": 1, "bloom_or_words": 1,
            "hash_only": 0, "walk_errors": chunks}
    if by_entry != want or launches != {
            "bloom_probe": 2, "bloom_or_words": 2, "walk_errors": chunks}:
        raise AssertionError(f"main path launched {by_entry} ({launches}), "
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
    os.remove(out2)

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
    return by_entry, src, out1


def phase_native_io(src, new_quals):
    """The native FASTQ codec against its NumPy versions on the main path's
    file: record scan + padded decode, and the quality write-back of the
    qualities the main path wrote; then BGZF of the rendered file (native,
    threaded) against the plain block-by-block deflate on its first 512
    blocks, and back."""
    from kbbq_tpu_torch.io import bgzf
    from kbbq_tpu_torch.io import fastq as tfq

    with open(src, "rb") as f:
        data = f.read()
    secs = {}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        secs[name] = time.time() - t0
        return out

    fq = timed("parse_native", tfq.parse_fastq_bytes, data)
    arrs = timed("extract_native", tfq.extract_padded_arrays, fq)
    fqp = timed("parse_plain", tfq.parse_fastq_bytes_plain, data)
    arrp = timed("extract_plain", tfq.extract_padded_arrays_plain, fqp)
    for name in ("buf", "name_starts", "name_ends", "seq_starts",
                 "seq_ends", "qual_starts", "qual_ends"):
        if not np.array_equal(getattr(fq, name), getattr(fqp, name)):
            raise AssertionError(f"native record scan differs: {name}")
    for a, b, name in zip(arrs, arrp, ("codes", "quals", "mask", "lens")):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"native decode differs: {name}")
    del arrp
    out = timed("render_native", tfq.render_fastq_with_quals, fq, new_quals,
                arrs[2])
    outp = timed("render_plain", tfq.render_fastq_with_quals_plain, fqp,
                 new_quals, arrs[2])
    if out != outp:
        raise AssertionError("native quality write-back differs")
    del outp, fqp, arrs
    gz = timed("bgzf_native", bgzf.compress, out)
    head = out[:512 * bgzf.BLOCK_SIZE]
    gz_head = timed("bgzf_plain_512_blocks", bgzf._compress_py, head)
    if bgzf.compress(head) != gz_head or not gz.startswith(gz_head[:-28]):
        raise AssertionError("native BGZF differs from the plain deflate")
    if timed("unbgzf_native", bgzf.decompress, gz) != out:
        raise AssertionError("BGZF round trip lost bytes")
    log(f"[native_io] {fq.num_reads} reads, {len(data)} bytes: native scan "
        f"+ decode and write-back equal the NumPy versions byte for byte; "
        f"BGZF {len(gz)} bytes at level 2, its first 512 blocks equal the "
        f"plain deflate's; seconds " + json.dumps(
            {k: round(v, 3) for k, v in secs.items()}))
    log(f"[native_io] {smi_line()}")
    return secs


def phase_streaming(tmp, src, out1, cfg, reads):
    """The streamed path at full size with the default window: its bytes
    are the resident main path's, launches asserted by entry point; then
    once more with no device window cache and windows of 100,003 reads."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.pipeline import recalibrate_fastq_streaming
    from kbbq_tpu_torch.pipeline.resident import DEFAULT_CHUNK_ROWS

    with open(out1, "rb") as f:
        want = f.read()
    out_s = os.path.join(tmp, "streamed.fq")
    timings: dict = {}
    kernels.reset_launches()
    t0 = time.time()
    info = recalibrate_fastq_streaming(src, out_s, cfg, timings=timings)
    torch.cuda.synchronize()
    wall = time.time() - t0
    by_entry = dict(kernels.ENTRY_LAUNCHES)
    peaks = {name[:-len("_peak_bytes")]: timings.pop(name)
             for name in sorted(timings) if name.endswith("_peak_bytes")}
    sizes = [min(STREAM_WINDOW, reads - s)
             for s in range(0, reads, STREAM_WINDOW)]
    W = len(sizes)
    walks = sum(-(-n // DEFAULT_CHUNK_ROWS) for n in sizes)
    want_launch = {"hash_build": W, "hash_only": 2 * W,
                   "bloom_probe_trust": W, "bloom_or_words": W,
                   "bloom_probe_words": W, "walk_errors": walks,
                   "bloom_probe_hashed": 0}
    if by_entry != want_launch or info["chunks"] != W:
        raise AssertionError(f"streamed path launched {by_entry} over "
                             f"{info['chunks']} windows, expected "
                             f"{want_launch}")
    with open(out_s, "rb") as f:
        if f.read() != want:
            raise AssertionError("streamed output differs from the resident "
                                 "main path's")
    os.remove(out_s)
    log(f"[streaming] {reads} reads in {W} windows ({sizes[0]} .. "
        f"{sizes[-1]} reads), output equal to the main path's byte for "
        f"byte; launches by entry {json.dumps(by_entry)}")
    log("[streaming] seconds by stage: " + json.dumps(timings))
    log("[streaming] peak device bytes by stage: " + json.dumps(peaks))

    # no device window cache, windows of 100,003 reads: every pass stages
    # its windows anew from the host cache
    out_n = os.path.join(tmp, "streamed_nocache.fq")
    t_n: dict = {}
    t1 = time.time()
    recalibrate_fastq_streaming(src, out_n, cfg, chunk_reads=100_003,
                                device_cache_bytes=0, timings=t_n)
    torch.cuda.synchronize()
    wall_n = time.time() - t1
    with open(out_n, "rb") as f:
        if f.read() != want:
            raise AssertionError("streamed output (no window cache, 100,003 "
                                 "reads a window) differs from the main "
                                 "path's")
    os.remove(out_n)
    t_n = {k: v for k, v in t_n.items() if not k.endswith("_peak_bytes")}
    log(f"[streaming] device window cache off, windows of 100003 reads, all "
        f"{reads} reads: equal bytes; seconds by stage " + json.dumps(t_n))
    result = {"reads": reads, "windows": W, "wall_s": wall,
              "reads_per_s": reads / wall, "timings": timings,
              "peak_device_bytes": peaks, "launches_by_entry": by_entry,
              "nocache_wall_s": wall_n, "card": smi_line()}
    log("[streaming] " + json.dumps(result))
    return by_entry


def phase_checkpoint(tmp):
    """Checkpoints on the midscale golden (20,000 reads, chunks of
    CKPT_CHUNK): a streamed run with checkpoint_dir; a rerun from all three
    pass artifacts that launches no kernel; a pass-4 resume from chunk 1
    with the sink cut there; the in-memory run_pipeline with
    checkpoint_dir.  All give the plain run's bytes; a changed k is
    refused."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.io.batcher import ReadArrays
    from kbbq_tpu_torch.io.stream import iter_fastq_chunks
    from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_fastq,
                                         recalibrate_fastq_streaming,
                                         run_pipeline)
    from kbbq_tpu_torch.utils.synth import to_fastq_bytes

    ds, k, cov, golden = midscale_dataset()
    src = os.path.join(tmp, "ck_in.fq")
    with open(src, "wb") as f:
        f.write(to_fastq_bytes(ds))
    cfg = RecalConfig(k=k, coverage=cov)
    plain, out = (os.path.join(tmp, n) for n in ("ck_plain.fq", "ck.fq"))
    ck = os.path.join(tmp, "ck")
    recalibrate_fastq(src, plain, cfg)
    with open(plain, "rb") as f:
        want = f.read()

    def run_streamed(**kw):
        recalibrate_fastq_streaming(src, out, cfg, chunk_reads=CKPT_CHUNK,
                                    checkpoint_dir=ck, **kw)
        torch.cuda.synchronize()
        with open(out, "rb") as f:
            return f.read() == want

    def meta(update=None):
        path = os.path.join(ck, "meta.json")
        with open(path) as f:
            m = json.load(f)
        if update is not None:
            update(m)
            with open(path, "w") as f:
                json.dump(m, f)
        return m

    ok = {"streamed": run_streamed()}
    done = meta()["passes_done"]
    chunks = meta()["pass4"]["chunks"]
    # a rerun with passes 1-3 on disk and pass 4 to write from chunk 0
    meta(lambda m: m.pop("pass4"))
    kernels.reset_launches()
    ok["from_passes"] = run_streamed()
    launched = dict(kernels.ENTRY_LAUNCHES)
    # pass 4 cut after its first chunk, garbage past that point
    n0 = next(iter_fastq_chunks(src, CKPT_CHUNK)).buf.size
    meta(lambda m: m.update(pass4={"chunks": 1, "bytes": n0}))
    with open(out, "ab") as f:
        f.write(b"GARBAGE")
    ok["pass4_resume"] = run_streamed()
    codes = np.stack([np.asarray(c) for c in ds.codes])
    quals = np.stack([np.asarray(q).astype(np.int8) for q in ds.quals])
    arrays = ReadArrays(codes, quals, np.ones(codes.shape, bool),
                        np.asarray(ds.rgs, np.int32),
                        np.asarray(ds.seconds, bool))
    got = run_pipeline(arrays, cfg, checkpoint_dir=os.path.join(tmp, "ck_m"))
    again = run_pipeline(arrays, cfg,
                         checkpoint_dir=os.path.join(tmp, "ck_m"))
    ok["in_memory"] = bool(np.array_equal(got, golden)
                           and np.array_equal(again, golden))
    try:
        recalibrate_fastq_streaming(src, out, RecalConfig(k=k - 1,
                                                          coverage=cov),
                                    chunk_reads=CKPT_CHUNK, checkpoint_dir=ck)
        guard = None
    except ValueError as e:
        guard = str(e)
    if not all(ok.values()) or any(launched.values()) or \
            done != ["rows_a", "rows_b", "covariates"] or guard is None or \
            "different parameters" not in guard:
        raise AssertionError(f"checkpoint runs: equal bytes {ok}, passes "
                             f"{done}, launches of the rerun {launched}, "
                             f"guard {guard!r}")
    log(f"[checkpoint] midscale ({len(ds.codes)} reads, {chunks} chunks of "
        f"{CKPT_CHUNK}): streamed with checkpoint_dir, rerun from the three "
        f"pass files (no kernel launched), pass-4 resume from chunk 1 and "
        f"in-memory run_pipeline(checkpoint_dir=) twice all give the plain "
        f"run's bytes ({ok}); k={k - 1} refused: {guard.split(';')[0]}")


def check_launches(route: str, by_entry: dict, want: dict) -> None:
    if by_entry != want:
        raise AssertionError(f"{route} launched {by_entry}, expected {want}")


def _uniform_records(buf, offs, sizes):
    """[n, 4 + size] view of records that all have one size and lie back to
    back from offset 0, or None."""
    n = offs.size
    rec = int(sizes[0]) + 4 if n else 0
    if n and (sizes == sizes[0]).all() and \
            (offs == 4 + np.arange(n, dtype=np.int64) * rec).all():
        return buf[:n * rec].reshape(n, rec)
    return None


def check_bam_output(inp, out, L):
    """Bytes of a set_oq output against its input, both (buf, offs, sizes)
    of the alignment section: every non-primary record unchanged; every
    primary one the same but for its block_size (grown by L + 4), its QUAL
    field and an appended OQ:Z tag that holds the input's QUAL + 33.
    Returns (primary, pass-through) record counts."""
    from kbbq_tpu_torch.io.bam_vec import bam_fields, primary_rows
    ib, io_, isz = inp
    ob, oo, osz = out
    f = bam_fields(ib, io_)
    prim = np.zeros(io_.size, bool)
    prim[primary_rows(f["flag"], f["l_seq"])] = True
    if not (f["l_seq"] == L).all() or oo.size != io_.size or \
            not np.array_equal(osz, isz + np.where(prim, L + 4, 0)):
        raise AssertionError("output records have other sizes than input "
                             "records + OQ tags")
    recs = _uniform_records(ib, io_, isz)
    if recs is None:
        raise AssertionError("the synthetic input's records are not uniform")
    R = recs.shape[1]
    qo = int(f["qual_off"][0] - io_[0]) + 4         # QUAL within a record
    grown = (int(isz[0]) + L + 4).to_bytes(4, "little")
    oq_tag = np.frombuffer(b"OQZ", np.uint8)
    ar = np.arange(R + L + 4)
    for s in range(0, io_.size, 65536):
        e = min(io_.size, s + 65536)
        p = prim[s:e]
        size = np.where(p, R + L + 4, R)
        o = ob[np.minimum(oo[s:e, None] - 4 + ar, ob.size - 1)]
        o[ar[None, :] >= size[:, None]] = 0
        i = recs[s:e]
        if not (np.array_equal(o[~p, :R], i[~p])
                and (o[p, :4] == np.frombuffer(grown, np.uint8)).all()
                and np.array_equal(o[p, 4:qo], i[p, 4:qo])
                and np.array_equal(o[p, qo + L:R], i[p, qo + L:R])
                and (o[p, R:R + 3] == oq_tag).all()
                and np.array_equal(o[p, R + 3:R + 3 + L],
                                   i[p, qo:qo + L] + np.uint8(33))
                and (o[p, R + 3 + L] == 0).all()):
            raise AssertionError(f"output records {s}..{e} differ from the "
                                 f"input outside QUAL and the OQ tag")
    return int(prim.sum()), int((~prim).sum())


def phase_bam(tmp, arrays, starts, cfg):
    """BASELINE config 3 at full size: the main path's reads as a
    coordinate-sorted BAM with three read groups, reverse-strand records
    and pass-through copies; the whole-file and the windowed route, the
    use_oq rerun, launches by entry point, the native codec against its
    NumPy versions.  Returns (whole-file, windowed) launches by entry."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.io import bgzf
    from kbbq_tpu_torch.io import bam_vec
    from kbbq_tpu_torch.io.bam import index_bam_bytes, read_bam_bytes
    from kbbq_tpu_torch.io.batcher import ReadArrays
    from kbbq_tpu_torch.pipeline import (recalibrate_bam,
                                         recalibrate_bam_streaming,
                                         run_pipeline)
    from kbbq_tpu_torch.pipeline.resident import DEFAULT_CHUNK_ROWS
    from kbbq_tpu_torch.utils.synth import (BAM_READ_GROUPS,
                                            arrays_to_bam_bytes)

    N, L = arrays.codes.shape
    secs = {}

    def timed(name, fn, *args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        secs[name] = round(time.time() - t0, 3)
        return out

    src = os.path.join(tmp, "reads.bam")
    data, rows = timed("write_input", arrays_to_bam_bytes, arrays, starts,
                       extra_share=BAM_EXTRA_SHARE)
    with open(src, "wb") as f:
        f.write(data)
    raw = timed("bgzf_inflate", bgzf.decompress, data)
    if timed("bgzf_deflate", bgzf.compress, raw) != data:
        raise AssertionError("BGZF round trip of the input changed its bytes")
    comp_bytes = len(data)
    del data

    # ---- decode check: the primaries against the generator's rows
    inp = timed("index", lambda: index_bam_bytes(raw)[2:])
    buf, offs, sizes = inp
    _, _, _, max_len, keys = bam_vec.scan_chunk(buf, offs, sizes, cfg.k)
    registry = {key: i for i, key in enumerate(keys)}
    codes, quals, mask, rgs, seconds, lens, prim = timed(
        "decode_native", bam_vec.decode_machine_chunk, buf, offs, sizes,
        max_len, registry)
    f = bam_vec.bam_fields(buf, offs)
    rev = (f["flag"][prim] & 0x10) != 0
    c_plain = np.empty((prim.size, L), np.int8)
    q_plain = np.empty((prim.size, L), np.int8)
    timed("decode_group_plain", bam_vec.decode_group_plain, buf,
          f["seq_off"][prim], f["qual_off"][prim], rev, L, False, c_plain,
          q_plain)
    timed("decode_group_native", bam_vec.decode_group, buf,
          f["seq_off"][prim], f["qual_off"][prim], rev, L, False, c_plain,
          q_plain)
    want_rgs = (np.arange(N) % len(BAM_READ_GROUPS)).astype(np.int32)
    checks = {
        "keys": keys == list(BAM_READ_GROUPS),
        "codes": np.array_equal(codes, arrays.codes[rows]),
        "quals": np.array_equal(quals, arrays.quals[rows]),
        "seconds": np.array_equal(seconds, arrays.seconds[rows]),
        "rgs": np.array_equal(rgs, want_rgs),
        "mask": bool(mask.all()) and max_len == L and prim.size == N,
        "plain_codes": np.array_equal(c_plain, codes),
        "plain_quals": np.array_equal(q_plain, quals)}
    if not all(checks.values()):
        raise AssertionError(f"decoded BAM differs from the generator: "
                             f"{checks}")
    extra = offs.size - N
    log(f"[bam] {offs.size} records ({N} primary, {extra} secondary or "
        f"supplementary), {len(raw)} bytes ({comp_bytes} as BGZF level 2); "
        f"decoded primaries equal the generator's rows (codes, quals, "
        f"seconds, read groups {keys} by order of first appearance)")
    sorted_arrays = ReadArrays(arrays.codes[rows], arrays.quals[rows],
                               mask, want_rgs, arrays.seconds[rows])
    del codes, quals, seconds, rgs, c_plain, q_plain

    def decoded_quals(path):
        b, o, s = index_bam_bytes(read_bam_bytes(path))[2:]
        return b, o, s, bam_vec.decode_machine_chunk(
            b, o, s, L, registry)[1]

    def peaks_of(t):
        return {k[:-len("_peak_bytes")]: t.pop(k) for k in sorted(t)
                if k.endswith("_peak_bytes")}

    # ---- whole-file route, set_oq
    out1, out2 = (os.path.join(tmp, n) for n in ("bam1.bam", "bam2.bam"))
    t_w: dict = {}
    kernels.reset_launches()
    t0 = time.time()
    info = recalibrate_bam(src, out1, cfg, set_oq=True, timings=t_w,
                           device=DEVICE)
    torch.cuda.synchronize()
    wall_w = time.time() - t0
    by_entry_w = dict(kernels.ENTRY_LAUNCHES)
    chunks = -(-N // DEFAULT_CHUNK_ROWS)
    check_launches("whole-file BAM route", by_entry_w, {
        "bloom_probe_trust": 1, "bloom_probe_words": 1,
        "bloom_probe_hashed": 0, "hash_build": 1, "bloom_or_words": 1,
        "hash_only": 0, "walk_errors": chunks})
    peaks_w = peaks_of(t_w)
    expected = run_pipeline(sorted_arrays, cfg, device=DEVICE)
    ob, oo, osz, got = decoded_quals(out1)
    diff = int((got != expected).sum())
    if diff:
        raise AssertionError(f"{diff} qualities of the whole-file BAM route "
                             f"differ from run_pipeline on the same arrays")
    n_prim, n_pass = check_bam_output(inp, (ob, oo, osz), L)
    del ob, oo, osz, expected
    recalibrate_bam(src, out2, cfg, set_oq=True, device=DEVICE)
    with open(out1, "rb") as f1, open(out2, "rb") as f2:
        first = f1.read()
        if f2.read() != first:
            raise AssertionError("second whole-file BAM run gave other bytes")
    os.remove(out2)
    log(f"[bam] whole-file route (set_oq): {wall_w:.3f} s, "
        f"{N / wall_w:.0f} reads/s; qualities equal run_pipeline's on the "
        f"same arrays; {n_prim} primary records equal the input outside "
        f"QUAL and the OQ tag (= input QUAL + 33), {n_pass} pass-through "
        f"records byte-identical; a second run wrote the same "
        f"{len(first)} bytes")
    log("[bam] whole-file seconds by stage: " + json.dumps(t_w))
    log("[bam] whole-file peak device bytes by stage: " + json.dumps(peaks_w))

    # ---- the native write-back and OQ append against their plain versions
    new_q = got
    qoff = f["qual_off"][prim]
    wb = buf.copy()
    timed("write_quals_native", bam_vec.write_quals, wb, qoff, lens, rev,
          new_q)
    wp = buf.copy()
    timed("write_quals_plain", bam_vec.write_quals_plain, wp, qoff, lens,
          rev, new_q)
    same_wq = np.array_equal(wb, wp)
    del wp
    a_n = timed("append_oq_native", bam_vec.append_oq, wb, buf, offs, sizes,
                prim, qoff, lens)
    a_p = timed("append_oq_plain", bam_vec.append_oq_plain, wb, buf, offs,
                sizes, prim, qoff, lens)
    if not (same_wq and np.array_equal(a_n, a_p)):
        raise AssertionError("native BAM write-back or OQ append differs "
                             "from its NumPy version")
    del wb, a_n, a_p, new_q, got
    log("[bam] native codec and NumPy versions byte for byte equal; seconds "
        + json.dumps(secs))

    # ---- windowed route: the same bytes
    out_s = os.path.join(tmp, "bam_streamed.bam")
    t_s: dict = {}
    kernels.reset_launches()
    t0 = time.time()
    info_s = recalibrate_bam_streaming(src, out_s, cfg, set_oq=True,
                                       timings=t_s, device=DEVICE)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    by_entry_s = dict(kernels.ENTRY_LAUNCHES)
    W = info_s["windows"]
    # a window is one raw chunk of 65,536 records: one walk launch each
    check_launches("windowed BAM route", by_entry_s, {
        "hash_build": W, "hash_only": 2 * W, "bloom_probe_trust": W,
        "bloom_or_words": W, "bloom_probe_words": W, "walk_errors": W,
        "bloom_probe_hashed": 0})
    peaks_s = peaks_of(t_s)
    with open(out_s, "rb") as f2:
        if f2.read() != first:
            raise AssertionError("windowed BAM route wrote other bytes than "
                                 "the whole-file route")
    os.remove(out_s)
    log(f"[bam] windowed route (set_oq): {W} windows, {wall_s:.3f} s, "
        f"{N / wall_s:.0f} reads/s; file equal to the whole-file route's "
        f"byte for byte; launches by entry {json.dumps(by_entry_s)}")
    log("[bam] windowed seconds by stage: " + json.dumps(t_s))
    log("[bam] windowed peak device bytes by stage: " + json.dumps(peaks_s))

    # ---- use_oq from the first output: OQ holds the input's qualities
    out3 = os.path.join(tmp, "bam_oq.bam")
    t0 = time.time()
    recalibrate_bam(out1, out3, cfg, use_oq=True, device=DEVICE)
    torch.cuda.synchronize()
    wall_oq = time.time() - t0
    q1 = decoded_quals(out1)[3]
    q3 = decoded_quals(out3)[3]
    if not np.array_equal(q1, q3):
        raise AssertionError("use_oq rerun gave other qualities than the "
                             "first run")
    log(f"[bam] use_oq rerun from the set_oq output: {wall_oq:.3f} s, "
        f"qualities equal the first run's")
    log(f"[bam] {smi_line()}")
    result = {"reads": N, "records": int(offs.size), "bytes": len(raw),
              "bgzf_bytes": comp_bytes, "whole_wall_s": wall_w,
              "whole_reads_per_s": N / wall_w, "whole_timings": t_w,
              "whole_peak_device_bytes": peaks_w,
              "whole_launches_by_entry": by_entry_w,
              "streamed_wall_s": wall_s, "streamed_reads_per_s": N / wall_s,
              "streamed_timings": t_s, "streamed_peak_device_bytes": peaks_s,
              "streamed_launches_by_entry": by_entry_s, "windows": W,
              "use_oq_wall_s": wall_oq, "codec_seconds": secs,
              "read_groups": info["read_groups"], "card": smi_line()}
    log("[bam] " + json.dumps(result))
    return by_entry_w, by_entry_s


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
                                            make_arrays_fast, read_starts)

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

    tmp = tempfile.mkdtemp(prefix="kbbq_smoke_")
    try:
        phase_golden(tmp)
        phase_report(tmp)
        launches, src, out1 = phase_main_path(tmp, fastq_bytes, true_err,
                                              expected, cfg, read_len)
        del fastq_bytes
        phase_native_io(src, expected)
        del expected
        streamed = phase_streaming(tmp, src, out1, cfg, args.reads)
        phase_checkpoint(tmp)
        bam, bam_streamed = phase_bam(
            tmp, arrays, read_starts(genome_len, read_len, args.reads,
                                     args.seed), cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for r in records:
        r["launches_streamed"] = streamed[r["entry"]]
        r["launches_bam"] = bam[r["entry"]]
        r["launches_bam_streamed"] = bam_streamed[r["entry"]]
        r["launches"] = (streamed if r.get("path") == "streamed"
                         else launches)[r["entry"]]
    log(f"[done] {time.time() - t_start:.0f} s in all")
    print(json.dumps({"kernels": records}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kbbq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full size, needs one CUDA card and nvcc
    python3 chip_smoke.py --reads N  # a smaller main-path dataset (debugging)
    python3 chip_smoke.py --scale-reads N   # config 4 cut to N reads (0: skip)

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
versions.  The resident path's peak device bytes per padded base at k = 16,
24 and 32 on a reduced input, held under the need ``fits_resident`` computes
from the shapes.  Then CRAM (BASELINE config 3 as CRAM): the same records
staged by ``arrays_to_cram_bytes`` in containers of 100,000 records, the
container-windowed route (``recalibrate_cram_stream_resident``) at full
size (qualities equal the whole-file BAM route's, every block but QS and the
non-primary QS bytes kept, a second run equal, launches per container, a
``use_oq`` rerun), the whole-file route (``recalibrate_cram``, per-record
decode and encode) on the first 131,072 reads to .cram and .bam (qualities
equal the windowed route's on that file), and the native rANS coder against
the NumPy coder on one container's QS block.  Then the command line
(``python -m kbbq_tpu_torch``, each run a process of its own, its launches
by entry point read back): config 2's FASTQ resident, streamed, with a
report and through ``applybqsr`` (the main path's bytes), config 3's BAM
whole-file and streamed (the [bam] route's bytes), the cut CRAM streamed
and to BAM (the [cram] route's output and qualities), ``benchmark`` on the
input and output BAM, ``--devices 0`` (every card: the main path's bytes)
and ``--devices 2`` (the same bytes on two cards or more, else refused with
the reference's message).  Between them, more than one device
(``kbbq_tpu_torch.parallel``, ``[devices]``): at D = the card count, one
process per card over NCCL, config 2's reads through run_pipeline's
multi-device route (the resident path on each rank's rows) and through
the streamed route on the ranks with a checkpoint, then resumed from its
filters, each the main path's bytes, launches summed over the ranks;
spawn seconds, the slowest rank's seconds by stage, the merges' seconds
and bytes.  Then the hash-space-sharded filters (``[sharded_kernels]``,
``[sharded]``): on config 2's reads, filters A and B built over 4 virtual
shards on the card (each fed the windows it owns) equal the one-device
filters word for word and every owner's word test answers as the whole
filter; the keep mode of the fused build, the rule-only trust and the
round-based walk (``walk_round``: walk_start, then per lane group
walk_propose, the word test and walk_resolve; with the local exchange, on
one chunk of 65,536 reads and on the whole data as one walk block) equal
their counterparts and plain versions, each timed (the entry points and
round 1's first group from CUDA graphs; rounds, groups and lanes by round
printed); then config 2 through run_pipeline's multi-device route with
bloom_layout="sharded" at D = the card count, the streamed route on the
ranks with a checkpoint and that run resumed after pass 2, each the main
path's bytes, launches by rank held to the run's shape, each rank holding
1/D of each filter, exchange seconds and bytes, the walk's rounds, lane
groups and collectives, pass 3 and peak device bytes printed.  Then
several hosts (``[multihost]``, ``kbbq_tpu_torch.parallel.multihost``):
host processes of ``python -m kbbq_tpu_torch recalibrate ... --multihost``
on this machine (one host of one card here; 2 hosts of half the cards each
where there are two or more), one NCCL group over them: config 2's reads
as 4 FASTQ files of unequal size with each filter layout (every output
the single host's streamed bytes), config 3's BAM (-s) and CRAM (at one
host the one part is the single host's file; at several, cat of the BAM
parts holds its records and of the CRAM parts is its bytes); launches by
rank held to each rank's windows; wall, start-up, spawn and each host's
stages printed.  Last, BASELINE.json config
4 on the one card: 13,000,000 reads x 150 at 30x (``make_arrays_chunked``,
a FASTQ over 2 GiB), the command line (its streamed engine) and the
resident route in process write the same bytes, and against the run's
filter B of 2^31 bits the walk equals its plain version on 8,192 reads and
a chunk, the walk and the cached word test timed; config 4's reads also
through the multi-device route at D ranks, the resident route's bytes; and
``[oracle]``: the resident run held to the port's NumPy oracle
(``scripts/torch_oracle_spot.py``) on 4,096 reads spread over all
13,000,000 ordinals, against filters A and B as the run built them, its
tables, Q' table and output (passes 1-4, covariates and deltas, every
check exact).  Before config 4, ``[scaling]`` (``bench_scaling_torch.py``'s
points on config 2's reads at D = 1, and at the card count where there
are two or more, parity-gated) and ``[config5]``
(``scripts/torch_config5_rehearsal.py`` at one host of one card, both
filters forced to 2^33 bits under the sharded layout: the single-process
bytes, the pass-2 peak's rise).  Any failed phase raises,
so the exit code is non-zero; without a CUDA device the script exits 1 at
once and prints no result.

Output, last three lines: a JSON object {"kernels": [...]} (one entry per
kernel entry point: launches on its path (``launches``: the resident main
path's count, the streamed path's for the hash-only entry, whose only path
it is; ``launches_streamed``, ``launches_bam``, ``launches_bam_streamed``,
``launches_cram`` (the whole-file CRAM route, reduced input) and
``launches_cram_streamed``, ``launches_cli`` (the command line's resident
FASTQ run), ``launches_scale`` and ``launches_scale_cli`` (config 4's
resident and command-line runs), ``launches_devices`` and
``launches_devices_by_rank`` (config 2's resident run on the ranks, summed
and per rank), ``launches_sharded``, ``launches_sharded_by_rank`` and
``launches_sharded_streamed`` (the same with the hash-space-sharded
filters: the resident run, the streamed run),
``launches_scale_devices_by_rank`` (config 4's) and
``launches_multihost_by_rank`` (the [multihost] FASTQ run with replicated
filters, by global rank) beside it in every entry;
the entries of the sharded layout's entry points (``path`` "sharded":
``launches`` is the sharded resident run's count, ``plain_ms`` of the walk's
three the plain walk of the chunk, whole, beside ``walk_ms``, ``rounds``,
``groups``, ``round1_group_graph_ms`` and the whole data's ``block_*``
figures); the probe's and
the walk's entries also their time, plain time and bound against config
4's filter B, ``scale_*``), mismatches against the plain
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

from kbbq_tpu_torch.utils.metrics import smi_line

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")

# NVIDIA H100 SXM data sheet: the device memory rate.  The kernels do integer
# work only, and an SM issues 64 integer ALU lanes a clock (four
# sub-partitions of 16 INT32 units; the data sheet's 67 TFLOP/s of float32
# counts 128 FP32 lanes and an FMA as two): the data sheet's 132 SMs at the
# 1.98 GHz boost clock, until [device] puts in the card's own SM count and
# clocks.max.sm.  Operations below are 32-bit integer operations.
PEAK_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
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
# fmix32: three xor-shifts (a shift and a xor each) and two multiplies
FMIX32_OPS = 8


def hash_ops(k: int, num_hashes: int, sample: bool = False,
             insert: bool = False) -> int:
    """Integer operations a window that the spec's hash needs, whatever the
    kernel: the forward k-mer and its reverse complement cut from packed
    strands (a funnel shift a 32-bit word each), the canonical pick (a
    compare and a select a word), validity (a funnel shift of the N mask and
    a test), the block and probe hashes (four fmix32, four xors), the probe
    word (a rotation, a shift and an or a probe bit) and the zero word of an
    invalid window; sampling adds the ordinal's mix (a multiply, a xor), a
    fifth fmix32, the threshold test and the validity; the insert its block
    index."""
    words = 1 if k <= 16 else 2
    ops = 2 * words + 2 * words + 2 + 4 * FMIX32_OPS + 4 + 3 * num_hashes + 1
    if sample:
        ops += 2 + FMIX32_OPS + 2
    if insert:
        ops += 1
    return ops


# Integer operations a window of the coverage rule (trusted_mask_batch): the
# hit and valid bits (a vote each); per base the hit and the valid windows
# that cover it (a funnel shift, a mask and a count each), t(x) and the
# compare, and the covered bit's vote; per window its covered bases (a
# funnel shift, a mask, a count), the compare with T and the validity.
TRUST_RULE_OPS = 2 + 6 + 2 + 1 + 3 + 2
KERNEL_SOURCE = "kbbq_tpu_torch/csrc/kbbq_kernels.cu"
CODEC_SOURCE = "kbbq_tpu_torch/csrc/kbbq_io.cc"
STREAM_WINDOW = 131_072      # reads per window of the streamed path
CKPT_CHUNK = 4096            # reads per chunk of the checkpoint runs
BAM_EXTRA_SHARE = 0.01       # primaries followed by a secondary/supplementary
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


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
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the integer operations over the integer ALU rate."""
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    to = ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a != b).sum().item())


# --------------------------------------------------------------- phases

def phase_device():
    global INT_OPS_PER_S
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.io import native_lib
    log(f"[device] {smi_line()}")
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True,
                           check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    INT_OPS_PER_S = sms * 64 * float(clock) * 1e6
    log(f"[device] {sms} SMs, SM clock at most {clock} MHz: the bounds take "
        f"{INT_OPS_PER_S / 1e12:.3f} T integer operations/s")
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
    shm = shutil.disk_usage("/dev/shm") if os.path.isdir("/dev/shm") else None
    log(f"[device] {torch.cuda.device_count()} CUDA device(s); /dev/shm "
        f"{shm.total if shm else 'absent'} B, {shm.free if shm else 0} B "
        f"free; temporary files under {tempfile.gettempdir()}: "
        f"{shutil.disk_usage(tempfile.gettempdir()).free} B free")
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
    # the spec's hash a window (hash_ops); bytes: 1 B per base read, 8 B per
    # window written
    record("bloom_or_words.hash_only", "hash_only",
           "kbbq_tpu/pipeline/stream_resident.py:108 + "
           "kbbq_tpu/pipeline/recalibrate.py:98",
           mm_ho, ho_ms, ho_plain_ms,
           bound(wr_s * L + nwin_s * 8, nwin_s * hash_ops(k, h)),
           n=nwin_s, graph_ms=ho_graph_ms, windows_checked=nwin,
           path="streamed",
           replaces_note="the XLA hash pass inside _p2_window and "
                         "_step_trusted; no Pallas counterpart")
    scratch = torch.empty_like(filt_a)
    fused_ms = cuda_ms(
        lambda: kernels.hash_build(codes, scratch, 0, k, h, thr),
        before=scratch.zero_)
    # the card's time alone: five builds into the same filter in a graph
    fused_graph_ms = cuda_graph_ms(
        lambda: kernels.hash_build(codes, scratch, 0, k, h, thr), launches=5)
    log(f"[kernels] bloom_or_words fused: {fused_ms:.4f} ms "
        f"({fused_graph_ms:.4f} from a graph)")
    # bytes: the codes, the three planes, filter A read and written;
    # operations: the spec's hash, sampling and insert a window
    record("bloom_or_words.hash_build", "hash_build",
           "kbbq_tpu/ops/bloom.py:164 + kbbq_tpu/pipeline/resident.py:330",
           sum(mm_f.values()), fused_ms, fused_plain_ms,
           bound(N * L + nwin * 9 + 2 * filt_a.numel() * 4,
                 nwin * hash_ops(k, h, sample=True, insert=True)),
           n=nwin, kept=kept_a, graph_ms=fused_graph_ms,
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
    # operations: the word test (a mask and a compare) and the rule
    record("bloom_probe.trust", "bloom_probe_trust",
           "kbbq_tpu/pipeline/resident.py:387 + kbbq_tpu/ops/trusted.py:57",
           mm_k1t + mm_k1t_low + mm_narrow, k1t_ms, k1t_plain_ms,
           bound(nwin * 9 + filt_a.numel() * 4, nwin * (TRUST_RULE_OPS + 2)),
           n=nwin,
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
    if by_entry != {**NO_LAUNCHES, **want} or launches != {
            "bloom_probe": 2, "bloom_or_words": 2, "walk_errors": chunks,
            "walk_round": 0}:
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
    if by_entry != {**NO_LAUNCHES, **want_launch} or info["chunks"] != W:
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


DEVICES_CHUNK = 65_536         # rows a walk launch covers (DEFAULT_CHUNK_ROWS)


def resident_ranks_launches(reads: int, world: int) -> dict:
    """Launches by entry point summed over `world` ranks of the resident
    path on `reads` rows split as ``parallel.mesh.row_range`` does."""
    from kbbq_tpu_torch.parallel.mesh import row_range
    rows = [e - s for s, e in (row_range(reads, world, r)
                               for r in range(world))]
    busy = sum(1 for n in rows if n)
    return {"bloom_probe_trust": busy, "bloom_probe_words": busy,
            "bloom_probe_hashed": 0, "hash_build": busy,
            "bloom_or_words": busy, "hash_only": 0,
            "walk_errors": sum(-(-n // DEVICES_CHUNK) for n in rows)}


def devices_line(route: str, t: dict, wall: float, by_entry: dict) -> dict:
    """Log one multi-device run: the group, start-up, the slowest rank's
    seconds by stage, the merges, the launches summed and by rank."""
    caller = {k: t[k] for k in ("scan", "share") if k in t}
    stages = {k: v for k, v in t.items()
              if isinstance(v, float) and not k.endswith("_peak_bytes")
              and k not in ("spawn", "merge", "exchange", *caller)}
    peaks = {k[:-len("_peak_bytes")]: v for k, v in t.items()
             if k.endswith("_peak_bytes")}
    shards = {k: t[k] for k in ("shard_words_a", "shard_words_b",
                                "walk_rounds", "walk_groups",
                                "walk_collectives") if t.get(k)}
    if "by_rank" in t:
        shards["peak_device_bytes_by_rank"] = [
            max((v for k, v in r.items() if k.endswith("_peak_bytes")),
                default=None) for r in t["by_rank"]]
    rec = {"route": route, "world": t["world"], "backend": t["backend"],
           "wall_s": wall, "caller_s": caller, "spawn_s": t["spawn"],
           "merge_s": t["merge"],
           "merge_bytes": t["merge_bytes"], "exchange_s": t["exchange"],
           "exchange_bytes": t["exchange_bytes"], "slowest_rank_s": stages,
           "peak_device_bytes": peaks, "launches_by_entry": by_entry,
           "launches_by_rank": t["launches_by_rank"], **shards}
    tag = "[sharded]" if "sharded" in route else "[devices]"
    log(f"{tag} {route}: {t['world']} rank(s) over {t['backend']}, "
        f"wall {wall:.3f} s of which spawn {t['spawn']:.3f} s and in the "
        f"caller {json.dumps(caller)}; merges "
        f"{t['merge']:.3f} s, {t['merge_bytes']} B sent by the busiest "
        f"rank; filter exchanges {t['exchange']:.3f} s, "
        f"{t['exchange_bytes']} B sent by the busiest rank; slowest rank's "
        f"seconds by stage {json.dumps(stages)}; peak device bytes by stage "
        f"{json.dumps(peaks)}; launches summed over ranks "
        f"{json.dumps(by_entry)}; peak device bytes by rank "
        f"{shards.get('peak_device_bytes_by_rank')}")
    if t.get("walk_groups"):
        log(f"{tag} {route}: the walk took {t['walk_rounds']} rounds (the "
            f"busiest rank's), {t['walk_groups']} lane groups and "
            f"{t['walk_collectives']} walk collectives; pass 3 "
            f"{stages.get('pass3')} s")
    return rec


def phase_devices(tmp, cfg, reads):
    """More than one device (``kbbq_tpu_torch.parallel``): at D =
    torch.cuda.device_count() ranks, one process per card over NCCL,
    config 2's reads (a) through run_pipeline's multi-device route (the
    resident path on each rank's rows, ``run_arrays_sharded``), its output
    FASTQ equal to the main path's bytes, and (b) through the streamed
    route on the ranks (``recalibrate_fastq_sharded``: rank 0 writes) with
    a checkpoint, then resumed from its filters: both equal to the main
    path's bytes.  Launches summed over the ranks are asserted by entry
    point.  Where D is at least 2 the resident run is repeated at 2 ranks;
    where D is 1 the exchange between cards cannot run (NCCL refuses two
    ranks on one card) and the line says so."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.parallel.sharded import (recalibrate_fastq_sharded,
                                                 run_arrays_sharded)
    from kbbq_tpu_torch.pipeline.recalibrate import (_load_fastq_arrays,
                                                     _write_fastq_outputs)

    D = torch.cuda.device_count()
    src, want = os.path.join(tmp, "reads.fq"), os.path.join(tmp, "out1.fq")
    fqs, mask_l, arrays = _load_fastq_arrays([src], False)
    runs = []
    for world in [D] + ([2] if D > 2 else []):
        out = os.path.join(tmp, f"ranks{world}.fq")
        t: dict = {}
        kernels.reset_launches()
        t0 = time.time()
        nq = run_arrays_sharded(arrays, cfg, world, DEVICE, t)
        wall = time.time() - t0
        by_entry = dict(kernels.ENTRY_LAUNCHES)
        _write_fastq_outputs(fqs, mask_l, nq, out)
        if "h2d" not in t:
            raise AssertionError(f"{world} ranks took the windowed engine, "
                                 f"not the resident path")
        check_launches(f"resident path on {world} ranks", by_entry,
                       resident_ranks_launches(reads, world))
        if not same_file(out, want):
            raise AssertionError(f"resident path on {world} ranks wrote "
                                 f"other bytes than the main path")
        os.remove(out)
        runs.append(devices_line(f"resident, {reads} reads", t, wall,
                                 by_entry))
    del fqs, mask_l, arrays, nq

    # the windowed engine on the ranks, rank 0 writing, with a checkpoint
    sizes = [min(STREAM_WINDOW, reads - s)
             for s in range(0, reads, STREAM_WINDOW)]
    W, walks = len(sizes), sum(-(-n // DEVICES_CHUNK) for n in sizes)
    ck, out = os.path.join(tmp, "ranks_ck"), os.path.join(tmp, "ranks_s.fq")
    for name, want_launch in (
            ("streamed with a checkpoint", {
                "hash_build": W, "hash_only": 2 * W, "bloom_probe_trust": W,
                "bloom_or_words": W, "bloom_probe_words": W,
                "walk_errors": walks, "bloom_probe_hashed": 0}),
            ("resumed after pass 2", {
                **NO_LAUNCHES, "hash_only": W, "bloom_probe_words": W,
                "walk_errors": walks})):
        if name.startswith("resumed"):
            path = os.path.join(ck, "meta.json")
            with open(path) as f:
                meta = json.load(f)
            if meta["passes_done"] != ["rows_a", "rows_b", "covariates"]:
                raise AssertionError(f"checkpoint of the ranks: {meta}")
            meta["passes_done"] = ["rows_a", "rows_b"]
            meta.pop("pass4", None)
            with open(path, "w") as f:
                json.dump(meta, f)
            os.remove(out)
        t = {}
        kernels.reset_launches()
        t0 = time.time()
        info = recalibrate_fastq_sharded(src, out, cfg, D, checkpoint_dir=ck,
                                         timings=t, device=DEVICE)
        wall = time.time() - t0
        by_entry = dict(kernels.ENTRY_LAUNCHES)
        check_launches(f"{name} on {D} ranks", by_entry, want_launch)
        if info["chunks"] != W or not same_file(out, want):
            raise AssertionError(f"{name} on {D} ranks wrote other bytes "
                                 f"than the main path")
        runs.append(devices_line(f"{name}, {W} windows", t, wall, by_entry))
    os.remove(out)
    shutil.rmtree(ck, ignore_errors=True)
    if D == 1:
        log("[devices] this machine has 1 CUDA device: every route ran at "
            "one NCCL rank (the collectives at world size 1); the exchange "
            "between cards (all_to_all, all-gather, all-reduce and the "
            "point-to-point pass-4 sends at 2 or more ranks) is unchecked "
            "here; scripts/torch_devices_check.py runs it on a host with "
            "several cards")
    log(f"[devices] {smi_line()}")
    result = {"devices": D, "runs": runs, "card": smi_line()}
    log("[devices] " + json.dumps(result))
    return runs[0]["launches_by_rank"], runs[0]["launches_by_entry"]


def phase_devices_scale(tmp, src, want, cfg, n, world=None,
                        layout="replicated", arrays=None):
    """Config 4's FASTQ (written by start_scale_data) through run_pipeline's
    multi-device route at D = `world` ranks (default device_count) with
    the filter `layout`: the resident path on each rank's rows, its output
    equal to the resident route's bytes (`want`), launches held to the
    run's shape, each sharded rank holding 1/D of each filter.  `arrays`:
    the file's (fqs, masks, ReadArrays) as ``_load_fastq_arrays`` gives
    them, read here when not given."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.parallel.mesh import row_range
    from kbbq_tpu_torch.parallel.sharded import run_arrays_sharded
    from kbbq_tpu_torch.parallel.sharded_bloom import sharded_params
    from kbbq_tpu_torch.pipeline.recalibrate import (_load_fastq_arrays,
                                                     _write_fastq_outputs)
    D = world or torch.cuda.device_count()
    t0 = time.time()
    fqs, mask_l, ra = arrays or _load_fastq_arrays([src], True)
    read_s = time.time() - t0
    torch.cuda.empty_cache()
    t: dict = {}
    kernels.reset_launches()
    t0 = time.time()
    nq = run_arrays_sharded(ra, cfg, D, DEVICE, t, None, layout)
    wall = time.time() - t0
    by_entry = dict(kernels.ENTRY_LAUNCHES)
    out = os.path.join(tmp, "ranks.fq")
    t1 = time.time()
    _write_fastq_outputs(fqs, mask_l, nq, out)
    write_s = time.time() - t1
    del nq
    if "h2d" not in t:
        raise AssertionError("config 4 on the ranks took the windowed "
                             "engine, not the resident path")
    route = f"config 4, resident, {n} reads"
    if layout == "sharded":
        w = ra.max_len - cfg.k + 1
        lens = ra.mask.sum(axis=1)
        alpha, coverage = cfg.resolve_alpha(int(lens.sum()))
        pa, pb = sharded_params(cfg, int(np.maximum(lens - cfg.k + 1,
                                                    0).sum()),
                                alpha, coverage, D)
        shares = [e - s for s, e in (row_range(n, D, r) for r in range(D))]
        check_sharded_launches(f"config 4, sharded, on {D} ranks",
                               t["launches_by_rank"],
                               sharded_want([[x] for x in shares], w,
                                            (1, 2, 3), True))
        if (t["shard_words_a"], t["shard_words_b"]) != (
                pa.m // 32 // D, pb.m // 32 // D):
            raise AssertionError(f"a rank held {t['shard_words_a']} and "
                                 f"{t['shard_words_b']} words of the "
                                 f"filters")
        route = f"config 4, sharded, resident, {n} reads"
    else:
        check_launches(f"config 4, resident path on {D} ranks", by_entry,
                       resident_ranks_launches(n, D))
    if not same_file(out, want):
        raise AssertionError(f"config 4 on {D} ranks ({layout}) wrote other "
                             f"bytes than the resident route")
    os.remove(out)
    rec = devices_line(route, t, wall, by_entry)
    log(f"[devices] config 4 at {D} ranks, {layout}: FASTQ read {read_s:.3f}"
        f" s and written {write_s:.3f} s in this process, outputs equal "
        f"byte for byte; {smi_line()}")
    return rec


SHARDS = 4                     # virtual shards of [sharded_kernels]


def phase_sharded_kernels(arrays, cfg):
    """The kernels of the hash-space-sharded layout on the card, on config
    2's reads.  Filters A and B are built split over SHARDS virtual shards
    (each shard fed only the windows it owns, through the cached build, as
    an owner builds) and the shards end to end must equal the one-device
    filters word for word; every owner's word test must answer as the whole
    filter does.  The keep mode of the fused build must write
    ``hash_build``'s planes and the plain hash pass's; the rule-only trust
    must equal ``bloom_probe_trust`` and ``trusted_mask_batch`` on the same
    hits; the round-based walk (``walk_round``: walk_start, then
    walk_propose, the word test and walk_resolve per round) on one chunk of
    65,536 reads with the local word test must mark what ``walk_errors`` and
    the plain walk mark.  Returns the records of the new entry points."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.ops import bloom as tb
    from kbbq_tpu_torch.ops.hash_cache import (hash_cache_build,
                                               hash_cache_chunk)
    from kbbq_tpu_torch.ops.inference import (LocalExchange, infer_errors,
                                              infer_errors_plain,
                                              infer_errors_sharded)
    from kbbq_tpu_torch.parallel.sharded_bloom import EXCHANGE_CHUNK
    from kbbq_tpu_torch.ops.trusted import (trusted_from_cache,
                                            trusted_mask_batch)
    from kbbq_tpu_torch.oracle import (alpha_threshold, bloom_params_for,
                                       coverage_thresholds)
    from kbbq_tpu_torch.constants import DEFAULT_EXT_CAP
    from kbbq_tpu_torch.pipeline.resident import DEFAULT_CHUNK_ROWS

    dev = torch.device(DEVICE)
    k, h = cfg.k, cfg.num_hashes
    N, L = arrays.codes.shape
    n = L - k + 1
    nwin = N * n
    rows = DEFAULT_CHUNK_ROWS
    W = min(cfg.ext_cap or DEFAULT_EXT_CAP, k)
    alpha, coverage = cfg.resolve_alpha(N * L)
    pa, pb = bloom_params_for(cfg, N * n, alpha, coverage)
    thr = int(alpha_threshold(alpha))
    T = k if cfg.trust_threshold is None else cfg.trust_threshold
    records = []

    def record(name, entry, replaces, mm, ms, plain_ms, bnd, **more):
        records.append({
            "name": name, "entry": entry, "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": replaces, "mismatches": mm,
            "max_abs_err": float(min(1, mm)), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "path": "sharded", **more})

    codes = torch.from_numpy(arrays.codes).to(dev)
    h1, word, keep, filt_a = hash_cache_build(codes, 0, k, h, thr, pa.log2_m)

    # ---- the keep mode of the fused entry point: hash_build's planes, and
    # the plain hash pass's (timed over every chunk)
    got = kernels.hash_keep(codes, 0, k, h, thr)
    mm_keep = sum(mismatches(a, b) for a, b in zip(got, (h1, word, keep)))
    del got
    torch.cuda.synchronize()
    t0 = time.time()
    for s in range(0, N, rows):
        e = min(N, s + rows)
        ids = torch.arange(s, e, dtype=torch.int64, device=dev)
        p1, pw, pk = hash_cache_chunk(codes[s:e], ids, k, h, thr)
        mm_keep += mismatches(p1, h1[s:e]) + mismatches(pw, word[s:e]) + \
            mismatches(pk, keep[s:e])
    torch.cuda.synchronize()
    keep_plain_ms = (time.time() - t0) * 1e3
    del p1, pw, pk
    keep_ms = cuda_ms(lambda: kernels.hash_keep(codes, 0, k, h, thr))
    keep_graph_ms = cuda_graph_ms(
        lambda: kernels.hash_keep(codes, 0, k, h, thr), launches=5)
    log(f"[sharded_kernels] hash_keep: {mm_keep} mismatches over {nwin} "
        f"windows (against hash_build's planes and the plain hash pass), "
        f"{keep_ms:.4f} ms ({keep_graph_ms:.4f} from a graph), plain "
        f"{keep_plain_ms:.1f} ms")
    # the fused build's bytes less the filter's; the spec's hash and
    # sampling a window
    record("bloom_or_words.hash_keep", "hash_keep",
           "kbbq_tpu/parallel/sharded_bloom.py:246", mm_keep, keep_ms,
           keep_plain_ms,
           bound(N * L + nwin * 9, nwin * hash_ops(k, h, sample=True)),
           n=nwin, kept=int(keep.sum()), graph_ms=keep_graph_ms,
           replaces_note="the XLA hash pass and sampling of step_sample; no "
                         "Pallas counterpart")

    # ---- filter A over SHARDS virtual shards: each shard built from the
    # kept windows it owns, then each owner's word test of its windows
    def shard_of(log2_m):
        """Words a shard holds, and each window's owner."""
        S = (1 << (log2_m - 5)) // SHARDS
        h1_u32 = h1.to(torch.int64) & 0xFFFFFFFF
        return S, (h1_u32 >> (S.bit_length() - 1)) & (SHARDS - 1)

    def split_build(log2_m, sel):
        S, owner = shard_of(log2_m)
        parts = []
        for d in range(SHARDS):
            m = sel & (owner == d)
            parts.append(kernels.bloom_or_words(
                torch.zeros(S, dtype=torch.int32, device=dev), h1[m],
                word[m], torch.ones(int(m.sum()), dtype=torch.bool,
                                    device=dev)))
        return parts, owner

    def split_test(parts, owner, filt):
        got = torch.zeros((N, n), dtype=torch.bool, device=dev)
        for d, part in enumerate(parts):
            m = (owner == d) & (word != 0)
            got[m] = kernels.bloom_probe_words(part, h1[m], word[m])
        return mismatches(got, tb.bloom_query_words(filt, h1, word))

    parts, owner = split_build(pa.log2_m, keep)
    mm_split = {"A_words": mismatches(torch.cat(parts), filt_a),
                "A_test": split_test(parts, owner, filt_a)}
    del parts, owner

    # ---- the rule-only trust on the hits of filter A: the fused trust
    # probe's bytes and the plain rule's
    hits = tb.bloom_query_words(filt_a, h1, word)
    t_table = torch.from_numpy(
        coverage_thresholds(alpha, k).astype(np.int32)).to(dev)
    trusted = kernels.trust_rule(hits, word, t_table, k, T)
    mm_rule = mismatches(trusted, trusted_from_cache(filt_a, h1, word,
                                                     t_table, k, T))
    torch.cuda.synchronize()
    t0 = time.time()
    for s in range(0, N, rows):
        e = min(N, s + rows)
        mm_rule += mismatches(trusted_mask_batch(hits[s:e], word[s:e] != 0,
                                                 t_table, k, T),
                              trusted[s:e])
    torch.cuda.synchronize()
    rule_plain_ms = (time.time() - t0) * 1e3
    out = torch.empty_like(trusted)
    rule_ms = cuda_ms(lambda: kernels.trust_rule(hits, word, t_table, k, T,
                                                 out=out))
    rule_graph_ms = cuda_graph_ms(lambda: kernels.trust_rule(
        hits, word, t_table, k, T, out=out), launches=5)
    del out, hits
    log(f"[sharded_kernels] trust_rule: {mm_rule} mismatches of {nwin} "
        f"(against bloom_probe_trust and the plain rule on the same hits), "
        f"{int(trusted.sum())} trusted; {rule_ms:.4f} ms "
        f"({rule_graph_ms:.4f} from a graph), plain {rule_plain_ms:.1f} ms")
    # bytes: the hit byte and the word in, the trusted byte out;
    # operations: the rule a window (TRUST_RULE_OPS)
    record("bloom_probe.trust_rule", "trust_rule",
           "kbbq_tpu/parallel/sharded_bloom.py:258", mm_rule, rule_ms,
           rule_plain_ms,
           bound(nwin * 6, nwin * TRUST_RULE_OPS), n=nwin,
           graph_ms=rule_graph_ms, trusted=int(trusted.sum()),
           replaces_note="trusted_mask_batch inside step_trusted after the "
                         "collective query; no Pallas counterpart")

    # ---- filter B over the shards, and its owners' tests
    filt_b = tb.bloom_build_words(h1, word, trusted, pb.log2_m)
    parts, owner = split_build(pb.log2_m, trusted)
    mm_split["B_words"] = mismatches(torch.cat(parts), filt_b)
    mm_split["B_test"] = split_test(parts, owner, filt_b)
    del parts, owner, trusted, keep, filt_a
    log(f"[sharded_kernels] filters A (2^{pa.log2_m} bits) and B "
        f"(2^{pb.log2_m}) built over {SHARDS} shards, each fed the windows "
        f"it owns: mismatches against the one-device filters and their word "
        f"tests {mm_split}")

    # ---- walk_round with the local exchange (the owner's word test of
    # the whole filter): on one chunk, then on the whole data as one block
    G = max(1, EXCHANGE_CHUNK // (3 * k))
    tr0_all = tb.bloom_query_words(filt_b, h1, word)
    del h1, word
    wr = min(WALK_READS, N)
    c, tr0 = codes[:wr], tr0_all[:wr]
    nw = (L + 31) // 32 + 1

    def round_walk(cc, tt, stats=None):
        ex = LocalExchange(filt_b)
        return infer_errors_sharded(cc, tt, ex, k, h, cfg.ext_cap, G,
                                    stats), ex

    def walk_check(cc, tt):
        """The round walk of cc against walk_errors and the plain walk
        (each per chunk of WALK_READS rows) -> its figures."""
        stats = {"walk_rounds": 0, "lanes_by_round": []}
        got, ex = round_walk(cc, tt, stats)
        mm, plain_s = 0, 0.0
        for s in range(0, cc.shape[0], WALK_READS):
            e = min(cc.shape[0], s + WALK_READS)
            mm += mismatches(got[s:e], infer_errors(
                filt_b, cc[s:e], k, h, cfg.ext_cap, trusted0=tt[s:e]))
            torch.cuda.synchronize()
            t0 = time.time()
            plain = infer_errors_plain(filt_b, cc[s:e], k, h, cfg.ext_cap,
                                       trusted0=tt[s:e])
            torch.cuda.synchronize()
            plain_s += time.time() - t0
            mm += mismatches(got[s:e], plain)
        del plain
        return dict(mismatches=mm, rounds=stats["walk_rounds"],
                    groups=ex.groups, pairs=ex.pairs,
                    lanes_by_round=stats["lanes_by_round"],
                    marks=int(got.sum()), plain_ms=plain_s * 1e3,
                    ms=cuda_ms(lambda: round_walk(cc, tt)))

    # bounds: walk_start reads the codes and trust and writes the state and
    # the lane list; a group's proposal reads each lane's id, cursor, three
    # packed words and k flags, and writes its asked pairs (8 B) and a slot
    # (4 B) per window and candidate, ~90 integer operations each (patch,
    # reverse complement, canonical form, two fmix32 pairs, the probe word);
    # the owner's test reads a pair and its filter word and writes an
    # answer; a resolve reads the lane's id, cursor, word, slots, answers and
    # flags, and writes flags, mark, word, cursor and list entry
    def start_bytes(rows):
        return rows * (L + n) + rows * (nw * 8 + n + L + 8 + 8)

    def propose_bytes(a, pairs):
        return a * (8 + 24 + k + 3 * k * 4) + pairs * 8

    def resolve_bytes(a, pairs):
        return a * (8 + 12 * k + 2 * k + 8 + 17) + pairs

    def walk_bound(rows, w):
        lanes = sum(w["lanes_by_round"])
        return bound(start_bytes(rows) + propose_bytes(lanes, w["pairs"])
                     + w["pairs"] * 13 + resolve_bytes(lanes, w["pairs"]),
                     rows * L * 12 + lanes * 3 * k * 90 + w["pairs"] * 4)

    chunk = walk_check(c, tr0)
    chunk_bound = walk_bound(wr, chunk)
    whole = walk_check(codes, tr0_all)
    whole_bound = walk_bound(N, whole)
    mm_walk = chunk["mismatches"] + whole["mismatches"]
    for name, w, rows, bnd in (("chunk", chunk, wr, chunk_bound),
                               ("block", whole, N, whole_bound)):
        lanes = w["lanes_by_round"]
        log(f"[sharded_kernels] walk_round on {rows} reads ({name}) with the "
            f"local exchange, lane groups of {G}: {w['mismatches']} "
            f"mismatches against walk_errors and the plain walk, "
            f"{w['marks']} bases marked, {w['rounds']} rounds, "
            f"{w['groups']} groups (the last agreement included), "
            f"{w['pairs']} pairs; lanes by round {lanes[:6]}...{lanes[-3:]}; "
            f"the walk {w['ms']:.4f} ms by events (plain "
            f"{w['plain_ms']:.1f} ms, bound {bnd[0]:.4f} ms, {bnd[1]})")

    # each entry point from CUDA graphs, on the chunk: start; round 1's
    # first group's proposal, the owner's word test of its pairs, its
    # resolve, and the whole group, each after the state is put back (the
    # restore's own time is taken off)
    start_graph_ms = cuda_graph_ms(lambda: kernels.walk_start(c, tr0, k, G))
    st = kernels.walk_start(c, tr0, k, G)
    A1 = int(st.ctl[3])                      # round 1's lanes
    saved = [x.clone() for x in (st.pk, st.fl, st.err, st.cur, st.lists,
                                 st.ctl)]

    def restore():
        for x, y in zip((st.pk, st.fl, st.err, st.cur, st.lists, st.ctl),
                        saved):
            x.copy_(y)

    def propose():
        restore()
        return kernels.walk_propose(st, h, 0, st.group)

    row1 = propose()[0].tolist()
    P1, g1 = row1[0], min(st.group, row1[1])

    def propose_test():
        pairs = propose()[1]
        return kernels.bloom_probe_words(filt_b, pairs[:P1, 0].contiguous(),
                                         pairs[:P1, 1].contiguous())

    def group1():
        kernels.walk_resolve(st, propose_test().view(torch.uint8), W, g1)

    restore_graph_ms = cuda_graph_ms(restore)
    propose_graph_ms = cuda_graph_ms(propose) - restore_graph_ms
    test_graph_ms = (cuda_graph_ms(propose_test) - restore_graph_ms
                     - propose_graph_ms)
    group_graph_ms = cuda_graph_ms(group1) - restore_graph_ms
    resolve_graph_ms = group_graph_ms - propose_graph_ms - test_graph_ms
    restore()
    del st, saved
    A = min(A1, G)                            # the first group's lanes
    start_bound = bound(start_bytes(wr), wr * L * 12)
    propose_bound = bound(propose_bytes(A, P1), A * 3 * k * 90)
    resolve_bound = bound(resolve_bytes(A, P1), A * (3 * k + n))
    group_bound = bound(propose_bytes(A, P1) + P1 * 13
                        + resolve_bytes(A, P1), A * 3 * k * 90 + P1 * 4)
    log(f"[sharded_kernels] walk_round entry points on the chunk, from "
        f"graphs: walk_start {start_graph_ms:.4f} ms (bound "
        f"{start_bound[0]:.5f}); round 1 ({A1} lanes) group 1 ({A} lanes, "
        f"{P1} pairs) {group_graph_ms:.4f} ms (bound {group_bound[0]:.5f}) "
        f"of which walk_propose {propose_graph_ms:.4f} (bound "
        f"{propose_bound[0]:.5f}), the word test {test_graph_ms:.4f} and "
        f"walk_resolve {resolve_graph_ms:.4f} (bound "
        f"{resolve_bound[0]:.5f}); the state's restore, "
        f"{restore_graph_ms:.4f} ms, taken off")
    walk_info = dict(
        rounds=chunk["rounds"], groups=chunk["groups"],
        lanes_by_round=chunk["lanes_by_round"], walk_ms=chunk["ms"],
        walk_plain_ms=chunk["plain_ms"], walk_bound_ms=chunk_bound[0],
        walk_bound_by=chunk_bound[1], marks=chunk["marks"], n=wr,
        group_lanes=G, round1_lanes=A1, round1_group_lanes=A,
        round1_group_graph_ms=group_graph_ms,
        round1_group_bound_ms=group_bound[0],
        word_test_graph_ms=test_graph_ms, restore_graph_ms=restore_graph_ms,
        block_reads=N, block_rounds=whole["rounds"],
        block_groups=whole["groups"],
        block_lanes_by_round=whole["lanes_by_round"],
        block_walk_ms=whole["ms"], block_plain_ms=whole["plain_ms"],
        block_bound_ms=whole_bound[0], block_mismatches=whole["mismatches"],
        plain_note="plain_ms: the plain walk of the chunk, whole "
                   "(infer_errors_plain)")
    replaces = "kbbq_tpu/ops/pallas_walk.py:242"
    note = ("_round_kernel where filter B is hash-space sharded "
            "(kbbq_tpu/parallel/sharded_bloom.py:276)")
    record("walk_round.start", "walk_start", replaces, mm_walk,
           cuda_ms(lambda: kernels.walk_start(c, tr0, k, G)),
           chunk["plain_ms"], start_bound, graph_ms=start_graph_ms,
           replaces_note=note, **walk_info)
    record("walk_round.propose", "walk_propose", replaces, mm_walk,
           propose_graph_ms, chunk["plain_ms"], propose_bound,
           graph_ms=propose_graph_ms, replaces_note=note, **walk_info)
    record("walk_round.resolve", "walk_resolve", replaces, mm_walk,
           resolve_graph_ms, chunk["plain_ms"], resolve_bound,
           graph_ms=resolve_graph_ms, replaces_note=note, **walk_info)
    del tr0_all
    del codes, filt_b, c, tr0
    bad = [r["name"] for r in records if r["mismatches"]]
    if bad or any(mm_split.values()):
        raise AssertionError(f"sharded kernels disagree: {bad} {mm_split}")
    log(f"[sharded_kernels] {smi_line()}")
    return records


def sharded_want(windows_by_rank, n: int, passes, resident: bool):
    """Per rank (the launches fixed by the data's shape, the owner's word
    tests at most, the owner's inserts at most) of a hash-space-sharded run
    whose rank r takes the windows of windows_by_rank[r] rows (the resident
    path: one window, the rank's rows) through `passes`, at n windows a
    read.  Every step exchanges in as many chunks as its busiest rank
    needs; an owner launches its test or build in a chunk only when it
    received pairs."""
    from kbbq_tpu_torch.parallel.sharded_bloom import (EXCHANGE_CHUNK,
                                                       WALK_BLOCK_ROWS)
    steps = max(len(w) for w in windows_by_rank)
    chunks = [max(-(-w[i] * n // EXCHANGE_CHUNK) if i < len(w) else 0
                  for w in windows_by_rank) for i in range(steps)]
    tests = ((2 in passes) + (3 in passes)) * sum(chunks)
    inserts = ((1 in passes) + (2 in passes)) * sum(chunks)
    out = []
    for wins in windows_by_rank:
        busy = sum(1 for w in wins if w)
        out.append(({"hash_keep": busy if 1 in passes else 0,
                     "hash_only": 0 if resident else
                     ((2 in passes) + (3 in passes)) * busy,
                     "trust_rule": busy if 2 in passes else 0,
                     "walk_start": sum(-(-w // WALK_BLOCK_ROWS)
                                       for w in wins) if 3 in passes else 0,
                     "bloom_probe_trust": 0, "bloom_probe_hashed": 0,
                     "hash_build": 0, "walk_errors": 0}, tests, inserts))
    return out


def check_sharded_launches(route: str, by_rank: list, want: list) -> None:
    """A sharded run's launches, rank by rank: the shape-fixed entry points
    exactly; a walk proposal on every rank for every lane group (the
    groups are collective), a resolve for every group of this rank that
    had lanes; the owner's word tests (one per chunk of the passes' tests
    that brought it pairs, and one per lane group that did) and builds
    within their counts, exactly so on one rank, where every chunk and
    every group but a block's last agreement brings pairs; a lane group
    somewhere."""
    groups = by_rank[0]["walk_propose"]
    for r, (got, (fixed, tests, inserts)) in enumerate(zip(by_rank, want)):
        bad = {e: (got[e], v) for e, v in fixed.items() if got[e] != v}
        if got["walk_propose"] != groups:
            bad["walk_propose"] = (got["walk_propose"], groups)
        if got["walk_resolve"] > groups - got["walk_start"]:
            bad["walk_resolve"] = (got["walk_resolve"], groups)
        probes, builds = got["bloom_probe_words"], got["bloom_or_words"]
        if len(by_rank) == 1:
            walked = groups - got["walk_start"]
            if (probes != tests + walked or builds != inserts
                    or got["walk_resolve"] != walked):
                bad["owner"] = (probes, builds, tests, inserts, walked)
        elif probes > tests + groups or builds > inserts or (
                inserts and not builds):
            bad["owner"] = (probes, builds, tests, inserts)
        if bad:
            raise AssertionError(f"{route}, rank {r}: launches {got}; "
                                 f"(got, expected): {bad}")
    if not groups:
        raise AssertionError(f"{route}: no walk lane group was launched")


def phase_sharded(tmp, cfg, reads, world=None):
    """The hash-space-sharded layout (``kbbq_tpu_torch.parallel.
    sharded_bloom``) at D = torch.cuda.device_count() ranks, one NCCL rank
    per card, on config 2's reads: run_pipeline's multi-device route with
    bloom_layout="sharded" (the resident path on each rank's rows, called
    as ``phase_devices`` calls it), then the streamed route on the ranks
    with a checkpoint, then resumed after pass 2 from the gathered filters.
    Each writes the main path's bytes; the launches by entry point and rank
    are held to the run's shape (``check_sharded_launches``); each rank held
    1/D of each filter.  `world` runs D ranks other than the card count.
    Returns the resident run's launches by rank and summed, and the
    streamed run's summed."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.parallel.mesh import row_range
    from kbbq_tpu_torch.parallel.sharded import (recalibrate_fastq_sharded,
                                                 run_arrays_sharded)
    from kbbq_tpu_torch.parallel.sharded_bloom import sharded_params
    from kbbq_tpu_torch.pipeline.recalibrate import (_load_fastq_arrays,
                                                     _write_fastq_outputs)

    D = world or torch.cuda.device_count()
    src, want = os.path.join(tmp, "reads.fq"), os.path.join(tmp, "out1.fq")
    fqs, mask_l, arrays = _load_fastq_arrays([src], False)
    n = arrays.max_len - cfg.k + 1
    lens = arrays.mask.sum(axis=1)
    alpha, coverage = cfg.resolve_alpha(int(lens.sum()))
    pa, pb = sharded_params(cfg, int(np.maximum(lens - cfg.k + 1, 0).sum()),
                            alpha, coverage, D)
    runs = []
    out = os.path.join(tmp, "sharded.fq")
    t: dict = {}
    kernels.reset_launches()
    t0 = time.time()
    nq = run_arrays_sharded(arrays, cfg, D, DEVICE, t, None, "sharded")
    wall = time.time() - t0
    by_entry = dict(kernels.ENTRY_LAUNCHES)
    _write_fastq_outputs(fqs, mask_l, nq, out)
    del fqs, mask_l, arrays, nq
    if "h2d" not in t:
        raise AssertionError("the sharded layout took the windowed engine, "
                             "not the resident path")
    shares = [e - s for s, e in (row_range(reads, D, r) for r in range(D))]
    check_sharded_launches(f"sharded resident path on {D} ranks",
                           t["launches_by_rank"],
                           sharded_want([[w] for w in shares], n, (1, 2, 3),
                                        True))
    if (t["shard_words_a"], t["shard_words_b"]) != (
            pa.m // 32 // D, pb.m // 32 // D):
        raise AssertionError(f"a rank held {t['shard_words_a']} and "
                             f"{t['shard_words_b']} words of the filters")
    if not same_file(out, want):
        raise AssertionError(f"the sharded layout on {D} ranks wrote other "
                             f"bytes than the main path")
    os.remove(out)
    runs.append(devices_line(f"sharded, resident, {reads} reads", t, wall,
                             by_entry))

    sizes = [min(STREAM_WINDOW, reads - s)
             for s in range(0, reads, STREAM_WINDOW)]
    W = len(sizes)
    by_rank_windows = [sizes[r::D] for r in range(D)]
    ck = os.path.join(tmp, "sharded_ck")
    for name, passes in (("streamed with a checkpoint", (1, 2, 3)),
                         ("resumed after pass 2", (3,))):
        if passes == (3,):
            path = os.path.join(ck, "meta.json")
            with open(path) as f:
                meta = json.load(f)
            if meta["passes_done"] != ["rows_a", "rows_b", "covariates"]:
                raise AssertionError(f"checkpoint of the ranks: {meta}")
            words = [np.load(os.path.join(ck, f"{f}.npy"), mmap_mode="r")
                     .shape[0] for f in ("rows_a", "rows_b")]
            if words != [pa.m // 32, pb.m // 32]:
                raise AssertionError(f"saved filters of {words} words")
            meta["passes_done"] = ["rows_a", "rows_b"]
            meta.pop("pass4", None)
            with open(path, "w") as f:
                json.dump(meta, f)
            os.remove(out)
        t = {}
        kernels.reset_launches()
        t0 = time.time()
        info = recalibrate_fastq_sharded(src, out, cfg, D, checkpoint_dir=ck,
                                         timings=t, device=DEVICE,
                                         bloom_layout="sharded")
        wall = time.time() - t0
        by_entry = dict(kernels.ENTRY_LAUNCHES)
        check_sharded_launches(f"sharded, {name}, on {D} ranks",
                               t["launches_by_rank"],
                               sharded_want(by_rank_windows, n, passes,
                                            False))
        if info["chunks"] != W or not same_file(out, want):
            raise AssertionError(f"sharded, {name}, on {D} ranks wrote "
                                 f"other bytes than the main path")
        runs.append(devices_line(f"sharded, {name}, {W} windows", t, wall,
                                 by_entry))
    os.remove(out)
    shutil.rmtree(ck, ignore_errors=True)
    log(f"[sharded] filters A 2^{pa.log2_m} and B 2^{pb.log2_m} bits, "
        f"{pa.m // 32 // D} and {pb.m // 32 // D} words a rank; "
        f"{smi_line()}")
    result = {"devices": D, "runs": runs, "card": smi_line()}
    if D == 1:
        log("[sharded] this machine has 1 CUDA device: the layout ran at one "
            "NCCL rank (every exchange at world size 1, each owner's shard "
            "the whole filter); the exchange between cards is unchecked "
            "here; scripts/torch_devices_check.py runs it on a host with "
            "several cards")
    log("[sharded] " + json.dumps(result))
    return (runs[0]["launches_by_rank"], runs[0]["launches_by_entry"],
            runs[1]["launches_by_entry"])


def check_launches(route: str, by_entry: dict, want: dict) -> None:
    """The launches by entry point of a route are `want`, every entry point
    `want` does not name at 0."""
    want = {**NO_LAUNCHES, **want}
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
    NumPy versions.  Returns (whole-file, windowed) launches by entry and
    the whole-file route's qualities (machine order, file order)."""
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
    del wb, a_n, a_p, new_q
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
    return by_entry_w, by_entry_s, got


RESIDENT_NEED_READS = 262_144   # reads of the resident-need runs
CRAM_WHOLE_READS = 131_072      # reads of the whole-file CRAM route's input
# the NumPy rANS coder, one operation in a process of its own: reads the
# input from argv[2], writes the result to argv[3], prints its seconds
_RANS_PLAIN = """
import sys, time
from kbbq_tpu_torch.io import cram_codecs as c
op, src, dst = sys.argv[1:4]
data = open(src, "rb").read()
fn = {"o0": c.rans_compress_o0_plain, "o1": c.rans_compress_o1_plain,
      "u0": c.rans_uncompress_plain, "u1": c.rans_uncompress_plain}[op]
t0 = time.time()
out = fn(data)
print(time.time() - t0)
open(dst, "wb").write(out)
"""


def phase_resident_need(arrays, cfg):
    """The resident path's peak device bytes per padded base at k = 16, 24
    and 32 on the first RESIDENT_NEED_READS reads, beside the need that
    ``fits_resident`` computes from the shapes; raises if the need is below
    a peak."""
    from kbbq_tpu_torch.io.batcher import ReadArrays
    from kbbq_tpu_torch.pipeline.recalibrate import (RecalConfig,
                                                     resident_need_bytes)
    from kbbq_tpu_torch.pipeline.resident import recalibrate_arrays_resident

    n = min(RESIDENT_NEED_READS, arrays.num_reads)
    sub = ReadArrays(arrays.codes[:n], arrays.quals[:n], arrays.mask[:n],
                     arrays.rgs[:n], arrays.seconds[:n])
    L = sub.max_len
    out = {}
    for k in (16, 24, 32):
        c = RecalConfig(k=k, coverage=cfg.coverage)
        t: dict = {}
        recalibrate_arrays_resident(sub, c, timings=t, device=DEVICE)
        peak = max(v for key, v in t.items() if key.endswith("_peak_bytes"))
        need = resident_need_bytes(n, L, n * L, n * (L - k + 1), c)
        out[k] = {"peak_bytes": peak, "need_bytes": need,
                  "peak_per_padded_base": peak / (n * L),
                  "need_per_padded_base": need / (n * L)}
        if need < peak:
            raise AssertionError(f"resident need {need} B at k={k} is below "
                                 f"the measured peak {peak} B")
    log(f"[resident_need] {n} reads x {L}: " + json.dumps(out))
    return out


def _cram_slices(path):
    """(comp, slice group, ref_names) per slice of a CRAM, in order."""
    from kbbq_tpu_torch.io.cram import (CramStream, parse_compression_header,
                                        split_slices)
    with CramStream(path) as cs:
        for _, blocks, raw in cs.containers():
            comp = parse_compression_header(blocks[0].data)
            for group in split_slices(blocks):
                yield comp, group, cs.ref_names


def cram_quals(path, L):
    """Machine-order qualities of a CRAM's primary records, int8 [n, L], by
    the wholesale slice decode."""
    from kbbq_tpu_torch.io.cram_vec import decode_slice_vec
    parts = []
    for comp, group, ref_names in _cram_slices(path):
        fast = decode_slice_vec(comp, group, None, ref_names, L,
                                np.zeros(8, np.int32), False)
        if fast is None:
            raise AssertionError(f"{path}: a slice needs the per-record "
                                 f"decoder")
        parts.append(fast[1])
    return np.concatenate(parts)


def check_cram_output(inp, out, L):
    """A streamed output against its input: the same header container and
    blocks, every block but each slice's QS block byte for byte, and in
    the QS stream every byte outside the primary records' spans (the
    secondary and supplementary copies' qualities).  Returns (blocks kept,
    QS blocks rewritten, non-primary QS bytes checked)."""
    from kbbq_tpu_torch.io.cram import (CT_EXTERNAL, CramStream,
                                        parse_compression_header,
                                        split_slices)
    from kbbq_tpu_torch.io.cram_vec import decode_slice_vec
    kept = rewritten = other_qs = 0
    with CramStream(inp) as a, CramStream(out) as b:
        if a.header_text != b.header_text:
            raise AssertionError("the header container changed")
        for (ca, ba, ra), (cb, bb, rb) in zip(a.containers(), b.containers(),
                                              strict=True):
            if (ca.n_records, ca.counter, len(ba)) != \
                    (cb.n_records, cb.counter, len(bb)):
                raise AssertionError("a container changed its records")
            comp = parse_compression_header(ba[0].data)
            body_a, body_b = ra[ca.body_pos:], rb[cb.body_pos:]
            if body_a[slice(*ba[0].span)] != body_b[slice(*bb[0].span)]:
                raise AssertionError("a compression header changed")
            for ga, gb in zip(split_slices(ba), split_slices(bb),
                              strict=True):
                fast = decode_slice_vec(comp, ga, None, a.ref_names, L,
                                        np.zeros(8, np.int32), False)
                sq = fast[7]
                for x, y in zip(ga, gb, strict=True):
                    if (x.content_type, x.content_id) != \
                            (y.content_type, y.content_id):
                        raise AssertionError("block order changed")
                    if x.content_type == CT_EXTERNAL and \
                            x.content_id == sq.qs_cid:
                        qa = np.frombuffer(x.data, np.uint8)
                        qb = np.frombuffer(y.data, np.uint8)
                        prim = np.zeros(qa.size, bool)
                        starts = np.repeat(sq.offs, sq.lens)
                        prim[starts + np.arange(starts.size)
                             - np.repeat(np.cumsum(sq.lens) - sq.lens,
                                         sq.lens)] = True
                        if qa.size != qb.size or \
                                (qa[~prim] != qb[~prim]).any():
                            raise AssertionError("QS bytes of non-primary "
                                                 "records changed")
                        rewritten += 1
                        other_qs += int((~prim).sum())
                    elif body_a[slice(*x.span)] != body_b[slice(*y.span)]:
                        raise AssertionError(f"block {x.content_id} of a "
                                             f"slice changed")
                    else:
                        kept += 1
    return kept, rewritten, other_qs


def phase_cram(tmp, arrays, starts, cfg, bam_quals):
    """BASELINE config 3 as CRAM: the [bam] phase's reads and records
    staged by arrays_to_cram_bytes (containers of 100,000 records); the
    container-windowed route at full size (qualities equal the whole-file
    BAM route's, every block but QS and the non-primary QS bytes kept, a
    second run equal, launches by entry per container, the use_oq rerun);
    the whole-file route on the first CRAM_WHOLE_READS reads (.cram and
    .bam outputs, qualities equal the windowed route's on that file); the
    native rANS coder against the NumPy coder on one container's QS block.
    Returns (whole-file, windowed) launches by entry."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.io import bam_vec
    from kbbq_tpu_torch.io.bam import index_bam_bytes, read_bam_bytes
    from kbbq_tpu_torch.io.batcher import ReadArrays
    from kbbq_tpu_torch.io import cram_codecs
    from kbbq_tpu_torch.io.cram import CT_EXTERNAL, CramStream
    from kbbq_tpu_torch.pipeline import (recalibrate_cram,
                                         recalibrate_cram_stream_resident)
    from kbbq_tpu_torch.pipeline.cram_stream import scan_cram_meta
    from kbbq_tpu_torch.pipeline.resident import DEFAULT_CHUNK_ROWS
    from kbbq_tpu_torch.utils.synth import arrays_to_cram_bytes

    N, L = arrays.codes.shape
    secs = {}

    def timed(name, fn, *args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        secs[name] = round(time.time() - t0, 3)
        return out

    def peaks_of(t):
        return {k[:-len("_peak_bytes")]: t.pop(k) for k in sorted(t)
                if k.endswith("_peak_bytes")}

    src = os.path.join(tmp, "reads.cram")
    data, _ = timed("write_input", arrays_to_cram_bytes, arrays, starts,
                    extra_share=BAM_EXTRA_SHARE)
    with open(src, "wb") as f:
        f.write(data)
    size = len(data)
    del data
    metas = timed("scan", scan_cram_meta, src, cfg.k, None)[0]
    records = sum(m["n_records"] for m in metas)
    W = sum(1 for m in metas if m["n_primary"])
    log(f"[cram] {records} records ({N} primary) in {len(metas)} "
        f"containers, {size} bytes")

    # ---- the container-windowed route at full size
    out1, out2 = (os.path.join(tmp, n) for n in ("cram1.cram", "cram2.cram"))
    t_s: dict = {}
    kernels.reset_launches()
    t0 = time.time()
    info = recalibrate_cram_stream_resident(src, out1, cfg, timings=t_s,
                                            device=DEVICE)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    by_entry_s = dict(kernels.ENTRY_LAUNCHES)
    walks = sum(-(-m["n_primary"] // DEFAULT_CHUNK_ROWS) for m in metas)
    check_launches("container-windowed CRAM route", by_entry_s, {
        "hash_build": W, "hash_only": 2 * W, "bloom_probe_trust": W,
        "bloom_or_words": W, "bloom_probe_words": W, "walk_errors": walks,
        "bloom_probe_hashed": 0})
    if info["windows"] != W:
        raise AssertionError(f"{info['windows']} windows, expected {W}")
    peaks_s = peaks_of(t_s)
    got = timed("decode_output", cram_quals, out1, L)
    diff = int((got != bam_quals).sum()) if got.shape == bam_quals.shape \
        else -1
    if diff:
        raise AssertionError(f"{diff} qualities of the windowed CRAM route "
                             f"differ from the whole-file BAM route's")
    kept, rewritten, other_qs = timed("check_output", check_cram_output,
                                      src, out1, L)
    recalibrate_cram_stream_resident(src, out2, cfg, device=DEVICE)
    with open(out1, "rb") as f1, open(out2, "rb") as f2:
        first = f1.read()
        if f2.read() != first:
            raise AssertionError("second windowed CRAM run gave other bytes")
    os.remove(out2)
    log(f"[cram] container-windowed route: {W} windows, {wall_s:.3f} s, "
        f"{N / wall_s:.0f} reads/s; qualities equal the whole-file BAM "
        f"route's; {kept} blocks byte-identical, {rewritten} QS blocks "
        f"rewritten, {other_qs} non-primary QS bytes kept; a second run "
        f"wrote the same {len(first)} bytes; launches by entry "
        f"{json.dumps(by_entry_s)}")
    log("[cram] windowed seconds by stage: " + json.dumps(t_s))
    log("[cram] windowed peak device bytes by stage: " + json.dumps(peaks_s))

    # ---- native rANS against the NumPy coder on the first container's QS
    with CramStream(src) as cs:
        _, blocks, _ = next(cs.containers())
        qs = next(b.data for b in blocks
                  if b.content_type == CT_EXTERNAL and b.content_id == 14)
    codec = {}
    blobs = {}
    for o, fn in ((0, cram_codecs.rans_compress_o0),
                  (1, cram_codecs.rans_compress_o1)):
        blobs[o] = timed(f"rans_o{o}_encode_native", fn, qs)
        if timed(f"rans_o{o}_decode_native", cram_codecs.rans_uncompress,
                 blobs[o], len(qs)) != qs:
            raise AssertionError(f"native rANS order {o} does not round-trip")
    paths = {}
    for name, data in (("qs", qs), ("b0", blobs[0]), ("b1", blobs[1])):
        paths[name] = os.path.join(tmp, f"rans_{name}.bin")
        with open(paths[name], "wb") as f:
            f.write(data)
    procs = {op: subprocess.Popen(
        [sys.executable, "-c", _RANS_PLAIN, op, paths[inp],
         os.path.join(tmp, f"rans_{op}.out")], cwd=HERE,
        stdout=subprocess.PIPE, text=True)
        for op, inp in (("o0", "qs"), ("o1", "qs"), ("u0", "b0"),
                        ("u1", "b1"))}
    for op, p in procs.items():
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"NumPy rANS {op} failed")
        codec[op] = round(float(out.strip()), 3)
        with open(os.path.join(tmp, f"rans_{op}.out"), "rb") as f:
            res = f.read()
        want = {"o0": blobs[0], "o1": blobs[1], "u0": qs, "u1": qs}[op]
        if res != want:
            raise AssertionError(f"NumPy rANS {op} differs from the native "
                                 f"codec")
    log(f"[cram] rANS on the first container's QS block ({len(qs)} bytes): "
        f"native and NumPy coders give the same bytes both ways; NumPy "
        f"seconds (one process each, all four together) "
        + json.dumps({f"numpy_{k}": v for k, v in codec.items()}))

    # ---- the whole-file route on the first CRAM_WHOLE_READS reads
    n = min(CRAM_WHOLE_READS, N)
    sub = ReadArrays(arrays.codes[:n], arrays.quals[:n], arrays.mask[:n],
                     arrays.rgs[:n], arrays.seconds[:n])
    small = os.path.join(tmp, "small.cram")
    with open(small, "wb") as f:
        data, rows_small = arrays_to_cram_bytes(sub, starts[:n],
                                                extra_share=BAM_EXTRA_SHARE)
        f.write(data)
    del data
    walls, t_w, by_entry_w = {}, {}, {}
    for ext in ("cram", "bam"):
        t: dict = {}
        kernels.reset_launches()
        t0 = time.time()
        recalibrate_cram(small, os.path.join(tmp, f"whole.{ext}"), cfg,
                         set_oq=True, timings=t, device=DEVICE)
        torch.cuda.synchronize()
        walls[ext] = time.time() - t0
        t_w[ext] = t
        by_entry_w[ext] = dict(kernels.ENTRY_LAUNCHES)
        check_launches(f"whole-file CRAM route (.{ext})", by_entry_w[ext], {
            "bloom_probe_trust": 1, "bloom_probe_words": 1,
            "bloom_probe_hashed": 0, "hash_build": 1, "bloom_or_words": 1,
            "hash_only": 0, "walk_errors": -(-n // DEFAULT_CHUNK_ROWS)})
    peaks_w = {ext: peaks_of(t) for ext, t in t_w.items()}
    recalibrate_cram_stream_resident(small, os.path.join(tmp, "small_s.cram"),
                                     cfg, device=DEVICE)
    q_s = cram_quals(os.path.join(tmp, "small_s.cram"), L)
    q_c = cram_quals(os.path.join(tmp, "whole.cram"), L)
    b, o, z = index_bam_bytes(read_bam_bytes(os.path.join(tmp,
                                                          "whole.bam")))[2:]
    q_b = bam_vec.decode_machine_chunk(b, o, z, L, None)[1]
    if not (np.array_equal(q_c, q_s) and np.array_equal(q_b, q_s)
            and q_s.shape == (n, L)):
        raise AssertionError("the whole-file CRAM route's qualities differ "
                             "from the windowed route's on the same file")
    log(f"[cram] whole-file route (set_oq) on the first {n} reads: .cram "
        f"{walls['cram']:.3f} s, .bam {walls['bam']:.3f} s; qualities of "
        f"both equal the windowed route's on that file")

    # ---- use_oq on the same reads: the windowed route's qualities as QS,
    # the input's as OQ
    new_q = np.empty_like(sub.quals)
    new_q[rows_small] = q_s
    oq_src = os.path.join(tmp, "small_oq.cram")
    with open(oq_src, "wb") as f:
        f.write(timed("write_oq_input", arrays_to_cram_bytes,
                      ReadArrays(sub.codes, new_q, sub.mask, sub.rgs,
                                 sub.seconds), starts[:n],
                      extra_share=BAM_EXTRA_SHARE, oq_quals=sub.quals)[0])
    del new_q
    out3 = os.path.join(tmp, "cram_oq.cram")
    t0 = time.time()
    recalibrate_cram_stream_resident(oq_src, out3, cfg, use_oq=True,
                                     device=DEVICE)
    torch.cuda.synchronize()
    wall_oq = time.time() - t0
    if not np.array_equal(cram_quals(out3, L), q_s):
        raise AssertionError("use_oq rerun gave other qualities than the "
                             "first run")
    for p in (oq_src, out3):
        os.remove(p)
    log(f"[cram] use_oq rerun on the first {n} reads (QS = the windowed "
        f"route's qualities, OQ = the input's): {wall_oq:.3f} s, qualities "
        f"equal the first run's")
    log("[cram] whole-file seconds by stage: " + json.dumps(t_w))
    log("[cram] whole-file peak device bytes by stage: "
        + json.dumps(peaks_w))
    log(f"[cram] {smi_line()}")
    result = {"reads": N, "records": records, "containers": len(metas),
              "bytes": size, "windows": W, "streamed_wall_s": wall_s,
              "streamed_reads_per_s": N / wall_s, "streamed_timings": t_s,
              "streamed_peak_device_bytes": peaks_s,
              "streamed_launches_by_entry": by_entry_s,
              "use_oq_wall_s": wall_oq, "whole_reads": n,
              "whole_wall_s": walls, "whole_timings": t_w,
              "whole_peak_device_bytes": peaks_w,
              "whole_launches_by_entry": by_entry_w,
              "host_seconds": secs, "rans_numpy_seconds": codec,
              "rans_block_bytes": len(qs), "card": smi_line()}
    log("[cram] " + json.dumps(result))
    return by_entry_w["cram"], by_entry_s


# the command line in a process of its own, as `python -m kbbq_tpu_torch`
# runs it (runpy); when it exits it writes to argv[1] the launches of each
# kernel entry point (none if it never loaded the kernels) and its peak
# resident set
MH_SHARES = (0.4, 0.3, 0.2, 0.1)   # config 2's reads in the [multihost] files
MH_TIMEOUT = 300                   # seconds a host process may take


def split_fastq(src, paths, shares) -> list:
    """Write `src`'s records into `paths` in order, `shares` of the records
    each (the last takes the rest) -> each file's read count."""
    buf = np.fromfile(src, np.uint8)
    nl = np.flatnonzero(buf == 10)
    n = nl.size // 4
    counts = [int(n * f) for f in shares[:-1]]
    counts.append(n - sum(counts))
    start = rec = 0
    for path, c in zip(paths, counts):
        rec += c
        end = int(nl[4 * rec - 1]) + 1 if rec else 0
        buf[start:end].tofile(path)
        start = end
    return counts


def run_hosts(tmp, argv, hosts: int, local: int, name: str, crash=None,
              cmd=None, timeout: float = MH_TIMEOUT):
    """`hosts` processes of ``python -m kbbq_tpu_torch <argv> --multihost
    --devices <local>`` (or of the command `cmd`) on this machine, one
    "host" each (its own cards by CUDA_VISIBLE_DEVICES where there are
    several hosts, its own session), over a coordinator on localhost ->
    (wall s on this clock, each host's stats line: the last line of its
    standard output, JSON), each host given `timeout` s.  With `crash` (a
    callable), host 1 is killed between pass 1 and pass 2
    (``KBBQ_CRASH_POINT``) and must exit 41; the other hosts,
    left waiting on it, are killed once ``crash()`` says pass 1's checkpoint
    is on disk, and no stats are read.  Every host's process group is
    killed at the end."""
    import signal
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    procs, logs = [], []
    t0 = time.time()
    try:
        for pid in range(hosts):
            e = dict(os.environ, JAX_COORDINATOR=coord,
                     JAX_NUM_PROCESSES=str(hosts), JAX_PROCESS_ID=str(pid))
            if hosts > 1:
                e["CUDA_VISIBLE_DEVICES"] = ",".join(
                    str(pid * local + i) for i in range(local))
            if crash:
                e["KBBQ_CRASH_POINT"] = "pass2:1"
            out, err = (os.path.join(tmp, f"{name}_host{pid}.{x}")
                        for x in ("out", "err"))
            logs.append((out, err))
            with open(out, "wb") as fo, open(err, "wb") as fe:
                procs.append(subprocess.Popen(
                    cmd or [sys.executable, "-m", "kbbq_tpu_torch", *argv,
                            "--multihost", "--devices", str(local)],
                    cwd=HERE, env=e, stdout=fo, stderr=fe,
                    start_new_session=True))
        if crash:
            code = procs[1].wait(timeout=timeout)
            if code != 41:
                raise AssertionError(f"{name}: host 1 exited {code}, not 41")
            deadline = time.time() + 120
            while not crash() and time.time() < deadline:
                time.sleep(0.2)
            if not crash():
                raise AssertionError(f"{name}: pass 1's checkpoint is "
                                     f"missing")
            return time.time() - t0, None
        deadline = time.time() + timeout
        codes = [p.wait(timeout=max(1.0, deadline - time.time()))
                 for p in procs]
        wall = time.time() - t0
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    stats = []
    for pid, (code, (out, err)) in enumerate(zip(codes, logs)):
        if code != 0:
            with open(err) as f:
                raise AssertionError(f"{name}: host {pid} exited {code}: "
                                     f"{f.read()[-3000:]}")
        with open(out) as f:
            stats.append(json.loads(f.read().splitlines()[-1]))
    return wall, stats


def mh_line(route: str, wall: float, stats: list, load: str = "") -> dict:
    """Log one multi-host run: the group, the wall, start-up, each host's
    own seconds, its slowest rank's stages, merges and exchanges, peak
    device bytes and the launches of every rank (global rank order)."""
    hosts = []
    for s in stats:
        t = s["timings"]
        hosts.append({
            "host": s["process_id"], "wall_s": s["wall_s"],
            "spawn_s": t["spawn"], "scan_s": t["scan"],
            "slowest_rank_s": {k: t[k] for k in ("setup", "pass1", "pass2",
                                                 "pass3", "deltas", "pass4")
                               if k in t},
            "merge_s": t["merge"], "merge_bytes": t["merge_bytes"],
            "exchange_s": t["exchange"],
            "exchange_bytes": t["exchange_bytes"],
            "walk_rounds": t["walk_rounds"], "walk_groups": t["walk_groups"],
            "peak_device_bytes": max((v for k, v in t.items()
                                      if k.endswith("_peak_bytes")),
                                     default=None),
            "windows": s["windows"], "reads": s["host_reads_written"]})
    by_rank = [r for s in stats for r in s["timings"]["launches_by_rank"]]
    rec = {"route": route, "hosts": len(stats),
           "ranks_per_host": stats[0]["local_devices"],
           "world": stats[0]["devices"], "layout": stats[0]["bloom_layout"],
           "wall_s": wall, "startup_s": wall - max(h["wall_s"] for h in hosts),
           "spawn_s": max(h["spawn_s"] for h in hosts), "by_host": hosts,
           "launches_by_rank": by_rank, "under_load": load or None}
    under = f", under load: {load}" if load else ""
    log(f"[multihost] {route}: {len(stats)} host(s) x "
        f"{rec['ranks_per_host']} rank(s), {rec['layout']}: wall "
        f"{wall:.3f} s{under} (process start-up {rec['startup_s']:.3f} s, "
        f"spawn {rec['spawn_s']:.3f} s); by host {json.dumps(hosts)}; launches by "
        f"rank {json.dumps(by_rank)}")
    return rec


def check_mh_launches(route: str, stats: list, windows_by_rank, n: int,
                      layout: str, passes=(1, 2, 3)) -> None:
    """A multi-host run's launches, rank by rank, held to its windows
    (windows_by_rank: each rank's windows' rows, global rank order) through
    `passes`."""
    by_rank = [r for s in stats for r in s["timings"]["launches_by_rank"]]
    if layout == "sharded":
        check_sharded_launches(route, by_rank,
                               sharded_want(windows_by_rank, n, passes,
                                            False))
        return
    # every pass of the windowed engine per window (pass 2 and 3 re-hash), a
    # walk launch per 65,536 rows; resumed after pass 1, no hash_build
    want = [{**NO_LAUNCHES, "hash_build": len(w) if 1 in passes else 0,
             "hash_only": 2 * len(w), "bloom_probe_trust": len(w),
             "bloom_or_words": len(w), "bloom_probe_words": len(w),
             "walk_errors": sum(-(-n // DEVICES_CHUNK) for n in w)}
            for w in windows_by_rank]
    for r, (got, w) in enumerate(zip(by_rank, want)):
        if {**NO_LAUNCHES, **got} != w:
            raise AssertionError(f"{route}, rank {r}: launched {got}, "
                                 f"expected {w}")


def phase_multihost(tmp, cfg, hosts: int, local: int,
                    routes=(("fastq", "replicated"), ("fastq", "sharded"),
                            ("bam", "replicated"), ("cram", "replicated")),
                    kill: bool = False, load: str = "") -> dict:
    """Several hosts (``kbbq_tpu_torch.parallel.multihost``) through the
    command line: `hosts` processes of `local` cards each, every one
    running ``python -m kbbq_tpu_torch recalibrate ... --multihost`` as a
    host would, one NCCL group over them all.  Config 2's reads split into
    4 FASTQ files of 40/30/20/10 %, each host its LPT share, every output
    the single host's streamed bytes; config 3's BAM ([bam]'s reads.bam, -s)
    and CRAM ([cram]'s reads.cram), each host a contiguous run of chunks or
    containers: at one host the one part is whole and is the single host's
    file, at several ``cat`` of the BAM parts holds its records and of the
    CRAM parts is its bytes.  Launches by rank held to each rank's windows;
    with `kill`, the FASTQ run again with host 1 killed between pass 1 and
    pass 2, then resumed (pass 1 loaded, not rewritten).  On one card the
    group is one rank and the exchange between hosts is unchecked; NCCL
    between real hosts is unchecked anywhere.  `load` says what runs beside
    the phase: each wall is logged as taken under it."""
    from kbbq_tpu_torch.io.bgzf import decompress
    from kbbq_tpu_torch.parallel.multihost import (partition_bam_chunks,
                                                   partition_inputs,
                                                   scan_bam_multihost)
    from kbbq_tpu_torch.pipeline import recalibrate_fastq_streaming
    from kbbq_tpu_torch.pipeline.cram_stream import scan_cram_meta

    t_phase = time.time()
    H, L = hosts, local
    flags = ["-k", str(cfg.k), "-c", f"{cfg.coverage:g}", "--batch-size",
             str(cfg.batch_size)]
    paths = [os.path.join(tmp, f"mh_in{i}.fq") for i in range(len(MH_SHARES))]
    want = [os.path.join(tmp, f"mh_want{i}.fq") for i in range(len(paths))]
    counts = split_fastq(os.path.join(tmp, "reads.fq"), paths, MH_SHARES)
    t0 = time.time()
    recalibrate_fastq_streaming(paths, want, cfg, device=DEVICE)
    torch.cuda.synchronize()
    one_wall = time.time() - t0
    under = f" (under load: {load})" if load else ""
    log(f"[multihost] config 2 as {len(paths)} FASTQ files of {counts} "
        f"reads; the single host's streamed route {one_wall:.3f} s{under}")

    def ranks_of(host_windows):
        return [w[r::L] for w in host_windows for r in range(L)]

    fq_windows = []
    for h in range(H):
        shard = partition_inputs(paths, counts, h, H)
        fq_windows.append([min(STREAM_WINDOW, c - s) for c in
                           shard.read_counts
                           for s in range(0, c, STREAM_WINDOW)])
    n_win = 150 - cfg.k + 1
    runs = {}
    for fmt, layout in routes:
        name = f"mh_{fmt}_{layout}"
        if fmt == "fastq":
            outs = [os.path.join(tmp, f"{name}{i}.fq")
                    for i in range(len(paths))]
            argv = ["recalibrate", *paths, *flags, "--bloom-layout", layout]
            for o in outs:
                argv += ["-o", o]
            wall, stats = run_hosts(tmp, argv, H, L, name)
            check_mh_launches(f"FASTQ, {layout}", stats, ranks_of(fq_windows),
                              n_win, layout)
            for o, w in zip(outs, want):
                if not same_file(o, w):
                    raise AssertionError(f"multi-host FASTQ ({layout}) wrote "
                                         f"other bytes than one host")
                os.remove(o)
        else:
            src = os.path.join(tmp, f"reads.{fmt}")
            single = os.path.join(tmp, f"{fmt}1.{fmt}")
            out = os.path.join(tmp, f"{name}.{fmt}")
            metas = (scan_bam_multihost(src, cfg.k, 1 << 16)[2]
                     if fmt == "bam" else scan_cram_meta(src, cfg.k, None)[0])
            wins = [[m["n_primary"] for m in metas[a:b] if m["n_primary"]]
                    for a, b in partition_bam_chunks(metas, H)]
            wall, stats = run_hosts(
                tmp, ["recalibrate", src, "-o", out, *flags,
                      "--bloom-layout", layout,
                      *(["-s"] if fmt == "bam" else [])], H, L, name)
            check_mh_launches(f"{fmt.upper()}, {layout}", stats,
                              ranks_of(wins), n_win, layout)
            parts = [f"{out}.part-{h:04d}-of-{H:04d}" for h in range(H)]
            if H == 1:
                ok = same_file(parts[0], single)
            else:
                cat = b"".join(open(p, "rb").read() for p in parts)
                with open(single, "rb") as f:
                    whole = f.read()
                ok = (decompress(cat) == decompress(whole) if fmt == "bam"
                      else cat == whole)
                del cat, whole
            if not ok:
                raise AssertionError(f"multi-host {fmt.upper()} ({layout}) "
                                     f"parts differ from one host's output")
            for p in parts:
                os.remove(p)
        if sum(s["host_reads_written"] for s in stats) != \
                stats[0]["num_reads"]:
            raise AssertionError(f"{name}: the hosts wrote "
                                 f"{[s['host_reads_written'] for s in stats]}"
                                 f" of {stats[0]['num_reads']} reads")
        runs[f"{fmt}, {layout}"] = mh_line(f"{fmt.upper()}, {layout}", wall,
                                            stats, load)

    if kill:
        ck = os.path.join(tmp, "mh_ck")
        outs = [os.path.join(tmp, f"mh_kill{i}.fq") for i in range(len(paths))]
        argv = ["recalibrate", *paths, *flags, "--checkpoint-dir", ck]
        for o in outs:
            argv += ["-o", o]
        rows_a = os.path.join(ck, "mh_rows_a.npy")

        def marked():
            try:
                with open(os.path.join(ck, "meta.json")) as f:
                    return "mh_rows_a" in json.load(f)["passes_done"]
            except (OSError, ValueError):
                return False

        wall_k, _ = run_hosts(tmp, argv, H, L, "mh_kill", crash=marked)
        mtime = os.path.getmtime(rows_a)
        wall, stats = run_hosts(tmp, argv, H, L, "mh_resume")
        check_mh_launches("FASTQ resumed after pass 1", stats,
                          ranks_of(fq_windows), n_win, "replicated", (2, 3))
        if os.path.getmtime(rows_a) != mtime or not all(
                same_file(o, w) for o, w in zip(outs, want)):
            raise AssertionError("the resumed multi-host run rewrote pass 1 "
                                 "or wrote other bytes than one host")
        runs["fastq, killed at pass2:1 then resumed"] = mh_line(
            "FASTQ, resumed after host 1 was killed at pass2:1", wall, stats,
            load)
        runs["fastq, killed at pass2:1 then resumed"]["killed_run_wall_s"] = \
            wall_k
        shutil.rmtree(ck, ignore_errors=True)
        for o in outs:
            os.remove(o)
    for p in paths + want:
        os.remove(p)
    if H * L == 1:
        log("[multihost] this machine has 1 CUDA device: one host of one "
            "NCCL rank (every collective at world size 1); the exchange "
            "between hosts is unchecked here; scripts/torch_devices_check.py "
            "runs 2 x 2 and 4 x 1 on four cards of one machine")
    log("[multihost] NCCL between real hosts is unchecked: every host here "
        f"is a process on one machine; {smi_line()}")
    result = {"hosts": H, "ranks_per_host": L, "single_host_wall_s": one_wall,
              "runs": runs, "seconds": time.time() - t_phase,
              "card": smi_line()}
    log("[multihost] " + json.dumps(result))
    return result


_CLI_RUNNER = """
import atexit, json, runpy, sys
from kbbq_tpu_torch.utils.metrics import peak_rss_bytes
counts = sys.argv.pop(1)
def report():
    k = sys.modules.get("kbbq_tpu_torch.kernels")
    with open(counts, "w") as f:
        json.dump({"launches": dict(k.ENTRY_LAUNCHES) if k else {},
                   "peak_rss_bytes": peak_rss_bytes()}, f)
atexit.register(report)
runpy.run_module("kbbq_tpu_torch", run_name="__main__", alter_sys=True)
"""
NO_LAUNCHES = {"bloom_probe_hashed": 0, "bloom_probe_words": 0,
               "bloom_probe_trust": 0, "trust_rule": 0, "bloom_or_words": 0,
               "hash_build": 0, "hash_keep": 0, "hash_only": 0,
               "walk_errors": 0, "walk_start": 0, "walk_propose": 0,
               "walk_resolve": 0}


def run_cli(tmp, argv, reads=None, expect_ok=True, name="cli", load=""):
    """One command-line run from the repo root -> (exit code, wall s, the
    command line's last stderr line, launches by entry point, its peak
    resident set in bytes).  Prints the wall, the reads/s and that line;
    `load` says what ran beside it, if anything did."""
    counts = os.path.join(tmp, f"{name}_launches.json")
    if os.path.exists(counts):
        os.remove(counts)
    t0 = time.time()
    res = subprocess.run([sys.executable, "-c", _CLI_RUNNER, counts, *argv],
                         cwd=HERE, capture_output=True, text=True,
                         timeout=900)
    wall = time.time() - t0
    err = res.stderr.strip().splitlines()
    last = err[-1] if err else ""
    if expect_ok and res.returncode != 0:
        raise AssertionError(f"kbbq_tpu_torch {' '.join(argv)} exited "
                             f"{res.returncode}: {res.stderr[-3000:]}")
    with open(counts) as f:
        got = json.load(f)
    rate = f", {reads / wall:.0f} reads/s" if reads else ""
    under = f" (under load: {load})" if load else ""
    log(f"[cli] python -m kbbq_tpu_torch {' '.join(argv)}: exit "
        f"{res.returncode}, {wall:.3f} s{rate}{under}, peak RSS "
        f"{got['peak_rss_bytes']} B; {last}")
    return (res.returncode, wall, last, {**NO_LAUNCHES, **got["launches"]},
            got["peak_rss_bytes"])


def same_file(a, b, block=64 << 20) -> bool:
    """Two files of equal bytes, read a block at a time."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as f, open(b, "rb") as g:
        while True:
            x, y = f.read(block), g.read(block)
            if x != y:
                return False
            if not x:
                return True


def calibration_gap(tsv) -> tuple:
    """(bases, count-weighted mean |reportedQ - actualQ|) of a benchmark
    TSV."""
    with open(tsv) as f:
        rows = [ln.rstrip("\n").split("\t") for ln in f.readlines()[1:]]
    n = np.asarray([int(r[3]) for r in rows], np.int64)
    gap = np.abs(np.asarray([int(r[1]) for r in rows], np.float64)
                 - np.asarray([float(r[2]) for r in rows]))
    return int(n.sum()), float((gap * n).sum() / max(int(n.sum()), 1))


def phase_cli(tmp, cfg, seed, genome_len, want):
    """The command line on the card, each run `python -m kbbq_tpu_torch`
    in a process of its own with the flags of the library call it is held
    against (the FASTQ, BAM and CRAM runs as three chains side by side, the
    last four runs side by side; walls are under that load): config 2's
    FASTQ resident and --stream (the [main_path]
    output's bytes), --report-out then applybqsr (the same bytes, no
    launch), config 3's BAM whole-file and --stream with -s ([bam]'s
    output), the [cram] phase's cut CRAM to .bam (its qualities) and
    --stream to .cram ([cram]'s windowed output on it), benchmark on the
    input and output BAM (same bases, the output's calibration gap below
    the input's), --devices 0 (the main path's bytes) and --devices 2 (the
    same bytes on two cards or more, else refused with the reference's
    message).  `want`: the launches by entry
    point of each route's library run.  Returns the resident FASTQ run's
    launches."""
    from kbbq_tpu_torch.io import bam_vec
    from kbbq_tpu_torch.io.bam import index_bam_bytes, read_bam_bytes
    from kbbq_tpu_torch.io.bam_stream import open_bam_stream
    from kbbq_tpu_torch.oracle.kmers import decode_seq
    from kbbq_tpu_torch.pipeline.cram_stream import scan_cram_meta
    from kbbq_tpu_torch.pipeline.resident import DEFAULT_CHUNK_ROWS

    # the earlier phases' files
    fq, fq_out = os.path.join(tmp, "reads.fq"), os.path.join(tmp, "out1.fq")
    bam, bam_out = (os.path.join(tmp, "reads.bam"),
                    os.path.join(tmp, "bam1.bam"))
    cram, cram_out = (os.path.join(tmp, "small.cram"),
                      os.path.join(tmp, "small_s.cram"))
    flags = ["-k", str(cfg.k), "-c", f"{cfg.coverage:g}", "--batch-size",
             str(cfg.batch_size)]
    n_fq = n_bam = want["reads"]
    L = want["read_len"]
    out = {}

    # every run here has others beside it: its wall is not a lone run's
    load = "other command lines run beside it"

    def check(name, argv, got, want_file=None, reads=None, launches=None):
        _, wall, last, by_entry, rss = run_cli(tmp, argv, reads, name=name,
                                               load=load)
        check_launches(f"command line ({name})", by_entry,
                       NO_LAUNCHES if launches is None else launches)
        if want_file is not None and not same_file(got, want_file):
            raise AssertionError(f"command line ({name}) wrote other bytes "
                                 f"than the library route")
        out[name] = {"wall_s": wall, "stderr": last, "peak_rss_bytes": rss,
                     "reads_per_s": reads / wall if reads else None,
                     "under_load": load}
        return by_entry

    cli_fq = os.path.join(tmp, "cli.fq")

    # three chains side by side, each in its order and with files of its
    # own: the card holds all three, and each is mostly process start-up
    def fastq_chain():
        resident = check("fastq", ["recalibrate", fq, "-o", cli_fq, *flags],
                         cli_fq, fq_out, n_fq, want["fastq"])
        check("fastq_stream", ["recalibrate", fq, "-o", cli_fq, "--stream",
                               *flags], cli_fq, fq_out, n_fq,
              want["fastq_stream"])
        report = os.path.join(tmp, "cli.report")
        check("fastq_report_out", ["recalibrate", fq, "-o", cli_fq,
                                   "--report-out", report, *flags], cli_fq,
              fq_out, n_fq, want["fastq"])
        check("applybqsr", ["applybqsr", "-r", report, fq, "-o", cli_fq,
                            *flags], cli_fq, fq_out, n_fq)
        os.remove(cli_fq)
        return resident

    def bam_chain():
        cli_bam = os.path.join(tmp, "cli.bam")
        check("bam_stream", ["recalibrate", bam, "-o", cli_bam, "-s",
                             "--stream", *flags], cli_bam, bam_out, n_bam,
              want["bam_stream"])
        check("bam", ["recalibrate", bam, "-o", cli_bam, "-s", *flags],
              cli_bam, bam_out, n_bam, want["bam"])

    def cram_chain():
        metas = scan_cram_meta(cram, cfg.k, None)[0]
        n_cram = sum(m["n_primary"] for m in metas)
        W = sum(1 for m in metas if m["n_primary"])
        cli_cram = os.path.join(tmp, "cli.cram")
        check("cram_stream", ["recalibrate", cram, "-o", cli_cram,
                              "--stream", *flags], cli_cram, cram_out,
              n_cram, {
            "hash_build": W, "hash_only": 2 * W, "bloom_probe_trust": W,
            "bloom_or_words": W, "bloom_probe_words": W,
            "walk_errors": sum(-(-m["n_primary"] // DEFAULT_CHUNK_ROWS)
                               for m in metas), "bloom_probe_hashed": 0})
        cram_bam = os.path.join(tmp, "cli_cram.bam")
        check("cram", ["recalibrate", cram, "-o", cram_bam, *flags], None,
              None, n_cram, want["cram"])
        b, o, z = index_bam_bytes(read_bam_bytes(cram_bam))[2:]
        if not np.array_equal(
                bam_vec.decode_machine_chunk(b, o, z, L, None)[1],
                cram_quals(cram_out, L)):
            raise AssertionError("the command line's CRAM -> BAM qualities "
                                 "differ from the windowed route's")
        os.remove(cram_bam)

    with ThreadPoolExecutor(3) as ex:
        chains = [ex.submit(f) for f in (fastq_chain, bam_chain, cram_chain)]
        resident = chains[0].result()
        for c in chains[1:]:
            c.result()

    # benchmark: the generator's genome (make_arrays_fast's first draw) as
    # the reference, under the BAM's @SQ name; no variable site
    genome = np.random.default_rng(seed).integers(0, 4, size=genome_len,
                                                  dtype=np.int8)
    _, refs, reader = open_bam_stream(bam)
    reader.f.close()
    ref = os.path.join(tmp, "ref.fa")
    with open(ref, "wb") as f:
        f.write(b">" + refs[0][0].encode() + b"\n" + decode_seq(genome)
                + b"\n")
    vcf = os.path.join(tmp, "none.vcf")
    with open(vcf, "wb") as f:
        f.write(b"##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\n")
    # side by side: the two benchmarks, --devices 2 and --devices 0 (every
    # card: one rank per card, or the one-device route on one card)
    tsv = {name: os.path.join(tmp, f"bench_{name}.tsv")
           for name in ("input", "output")}
    D = torch.cuda.device_count()
    cli_all = os.path.join(tmp, "cli_all.fq")
    with ThreadPoolExecutor(4) as ex:
        runs = [ex.submit(check, f"benchmark_{name}",
                          ["benchmark", "-b", src, "-r", ref, "-v", vcf,
                           "-l", name, "-o", tsv[name]], None, reads=n_bam)
                for name, src in (("input", bam), ("output", bam_out))]
        two = ex.submit(run_cli, tmp, ["recalibrate", fq, "-o", cli_fq,
                                       "--devices", "2", *flags],
                        expect_ok=D >= 2, name="devices", load=load)
        every = ex.submit(check, "devices_0", ["recalibrate", fq, "-o",
                                               cli_all, "--devices", "0",
                                               *flags], cli_all, fq_out,
                          n_fq, want["fastq"] if D == 1 else
                          resident_ranks_launches(n_fq, D))
        for r in runs:
            r.result()
        rc, _, last, by_entry, _ = two.result()
        every.result()
    os.remove(cli_all)
    log(f"[devices] python -m kbbq_tpu_torch recalibrate --devices 0 ({D} "
        f"card(s)): the main path's bytes; run "
        f"{json.dumps(out['devices_0'])}")
    if D >= 2:
        if not same_file(cli_fq, fq_out):
            raise AssertionError("--devices 2 wrote other bytes than the "
                                 "main path")
        os.remove(cli_fq)
    elif rc != 1 or f"--devices 2 requested but only {D} device(s) " \
            f"available" not in last or any(by_entry.values()) or \
            os.path.exists(cli_fq):
        raise AssertionError(f"--devices 2 on {D} card(s) was not refused "
                             f"as the reference refuses it: exit {rc}, "
                             f"{last!r}")
    gaps = {name: calibration_gap(path) for name, path in tsv.items()}
    # every base of every primary record is aligned and scored
    if not gaps["input"][0] == gaps["output"][0] == n_bam * L or \
            not gaps["output"][1] < gaps["input"][1]:
        raise AssertionError(f"benchmark (bases, calibration gap): {gaps}")
    log(f"[cli] benchmark: {gaps['input'][0]} bases in both; count-weighted "
        f"mean |reportedQ - actualQ| {gaps['input'][1]:.4f} in the input, "
        f"{gaps['output'][1]:.4f} in the output")

    log(f"[cli] {smi_line()}")
    log("[cli] " + json.dumps({"runs": out, "calibration_gap": gaps,
                               "card": smi_line()}))
    return resident


SCALE_READS = 13_000_000      # BASELINE config 4: chr20-class, 30x, 2x150
SCALE_COVERAGE = 30.0
SCALE_READ_LEN = 150
SCALE_SAMPLE = 8192           # reads of the walk's check at filter B
# host bytes per read held at once at the scale phase's peak: the data
# generator's arrays (450, in a process of its own), the resident run's file
# (318), its decode (450), new qualities (150) and rendered output (318),
# with a margin
SCALE_HOST_BYTES_PER_READ = 2048
SCALE_DISK_BYTES_PER_READ = 3 * 318      # input and two outputs
# make_arrays_chunked's reads rendered to a FASTQ in a process of its own:
# argv reads, coverage, seed, path; prints its seconds as JSON
_SCALE_DATA = """
import json, sys, time
from kbbq_tpu_torch.utils.metrics import peak_rss_bytes
from kbbq_tpu_torch.utils.synth import arrays_to_fastq_file, make_arrays_chunked
n, cov, seed, path = int(sys.argv[1]), float(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
t0 = time.time()
a = make_arrays_chunked(n, 150, cov, seed)
t1 = time.time()
size = arrays_to_fastq_file(a, path)
print(json.dumps({"generate_s": t1 - t0, "render_s": time.time() - t1,
                  "bytes": size, "peak_rss_bytes": peak_rss_bytes()}))
"""


def start_scale_data(reads, seed):
    """Cut `reads` to what the host's memory and the disk hold, and start
    writing config 4's FASTQ in a process of its own (it runs beside the
    [multihost] and [cli] phases) -> the job for phase_scale."""
    with open("/proc/meminfo") as f:
        mem_total = next(int(ln.split()[1]) * 1024 for ln in f
                         if ln.startswith("MemTotal:"))
    tmp = tempfile.mkdtemp(prefix="kbbq_scale_")
    disk_free = shutil.disk_usage(tmp).free
    n = min(reads, int(mem_total * 0.8) // SCALE_HOST_BYTES_PER_READ,
            int(disk_free * 0.9) // SCALE_DISK_BYTES_PER_READ)
    log(f"[scale] host MemTotal {mem_total} B, {disk_free} B free on {tmp}: "
        f"{n} reads" + ("" if n == reads else f" (cut from {reads})"))
    src = os.path.join(tmp, "in.fq")
    proc = subprocess.Popen(
        [sys.executable, "-c", _SCALE_DATA, str(n), str(SCALE_COVERAGE),
         str(seed), src], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return {"tmp": tmp, "proc": proc, "src": src, "reads": n,
            "asked": reads, "seed": seed, "t0": time.time()}


def stop_scale_data(job) -> None:
    if job is None:
        return
    if job["proc"].poll() is None:
        job["proc"].kill()
        job["proc"].wait()
    shutil.rmtree(job["tmp"], ignore_errors=True)


ORACLE_SAMPLE = 4096          # reads of [oracle], spread over every ordinal


def load_script(rel: str):
    """A script of this checkout (path relative to it) as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(rel))[0], os.path.join(HERE, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_oracle(spot, src, out, kept, cfg, info) -> dict:
    """[oracle]: config 4's resident run held to the port's NumPy oracle
    (``scripts/torch_oracle_spot.py``) on ORACLE_SAMPLE reads spread over
    all its ordinals, against filters A and B as the run built them (kept
    by ``kept_resident_run``), its tables, Q' table and output; every
    check must count 0."""
    tables = kept["captured"]["tables"]
    n = info["num_reads"]
    t0 = time.time()
    rows = spot.read_sample(src, out,
                            spot.sample_ordinals(n, ORACLE_SAMPLE),
                            tables.max_len, True)
    read_s = time.time() - t0
    if rows["num_reads"] != n:
        raise AssertionError(f"[oracle] read {rows['num_reads']} of {n} "
                             f"reads")
    res = spot.oracle_spot(rows, kept["a"][-1], kept["b"][-1], tables,
                           kept["recal"][-1], rows["usable_bases"], cfg,
                           info["total_bases"], DEVICE)
    res["read_s"] = read_s
    log(f"[oracle] {json.dumps(res)}; {smi_line()}")
    spot.check(res)
    return res


def phase_scaling(reads: int) -> dict:
    """[scaling]: ``bench_scaling_torch.run_points`` on config 2's count of
    reads at D = 1 (and at the card count where there are two or more),
    each point parity-gated against D = 1."""
    bench = load_script("bench_scaling_torch.py")
    D = torch.cuda.device_count()
    res = bench.run_points(reads, 150, 32, 8192, sorted({1, D}))
    for p in res["points"]:
        log(f"[scaling] {json.dumps(p)}")
        if not p["parity_vs_1dev"]:
            raise AssertionError(f"[scaling] D = {p['devices']} wrote other "
                                 f"bytes than D = 1")
    log(f"[scaling] {json.dumps(res)}")
    return res


def phase_config5() -> dict:
    """[config5]: ``scripts/torch_config5_rehearsal.py`` at one host of one
    card, both filters forced to 2^33 bits under the sharded layout, at its
    default 12,000 reads: the host process writes the single-process
    bytes, its rank holds the whole filters, and its pass-2 peak rises by
    their growth."""
    c5 = load_script("scripts/torch_config5_rehearsal.py")
    res = c5.rehearse(c5.READS, [33], [(1, 1)])
    log(f"[config5] {json.dumps(res)}")
    return res


def phase_scale(job):
    """BASELINE config 4 on one card: make_arrays_chunked's reads as a
    FASTQ over 2 GiB (start_scale_data), (a) the command line (its streamed
    engine, by the size rule), (b) the resident library route in process:
    the same bytes, launches by entry point, seconds and peak device bytes
    by stage; then, against filter B as the resident run built it,
    walk_errors against its plain version on the first SCALE_SAMPLE reads
    and on one chunk (and timed from a CUDA graph), and the cached word test
    over the windows of the first FULL_READS reads (against its plain
    version, timed, beside the library's gather).  Between them
    ``phase_devices_scale`` and ``phase_oracle``, against both filters as
    the resident run built them (kept until then, so its pass-3 and pass-4
    peaks hold filter A too)."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.cli.main import AUTO_STREAM_BYTES
    from kbbq_tpu_torch.constants import DEFAULT_EXT_CAP
    from kbbq_tpu_torch.io.fastq import extract_padded_arrays, parse_fastq_bytes
    from kbbq_tpu_torch.ops import bloom as tb
    from kbbq_tpu_torch.ops.hash_cache import hash_cache_build
    from kbbq_tpu_torch.ops.inference import infer_errors, infer_errors_plain
    from kbbq_tpu_torch.ops.kmers import u32_to_wide
    from kbbq_tpu_torch.oracle import bloom_params_for
    from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_fastq
    from kbbq_tpu_torch.pipeline.recalibrate import resident_need_bytes
    import resource

    from kbbq_tpu_torch.pipeline.resident import DEFAULT_CHUNK_ROWS
    from kbbq_tpu_torch.utils.metrics import peak_rss_bytes

    tmp, src, n, seed = job["tmp"], job["src"], job["reads"], job["seed"]
    out, err = job["proc"].communicate(timeout=1200)
    if job["proc"].returncode != 0:
        raise AssertionError(f"config 4's data generator failed: "
                             f"{err[-3000:]}")
    made = json.loads(out.strip().splitlines()[-1])
    size = made["bytes"]
    L, k = SCALE_READ_LEN, 32
    cfg = RecalConfig(k=k, coverage=SCALE_COVERAGE)
    genome_len = max(1000, int(n * L / SCALE_COVERAGE))
    alpha, cov = cfg.resolve_alpha(n * L)
    pa, pb = bloom_params_for(cfg, n * (L - k + 1), alpha, cov)
    log(f"[scale] {n} reads x {L} from a {genome_len} bp genome, seed {seed}"
        f": generated in {made['generate_s']:.1f} s and {size} B of FASTQ "
        f"written in {made['render_s']:.1f} s (in a process of its own, "
        f"beside [cli]; {time.time() - job['t0']:.1f} s after its start); "
        f"{n * (L - k + 1)} windows, filter A 2^{pa.log2_m} and B 2^"
        f"{pb.log2_m} bits (log2_m {pa.log2_m} / {pb.log2_m})")

    # ---- (a) the command line: over 2 GiB, so the streamed engine
    torch.cuda.empty_cache()
    cli_fq = os.path.join(tmp, "cli.fq")
    W = -(-n // STREAM_WINDOW)
    sizes = [min(STREAM_WINDOW, n - s) for s in range(0, n, STREAM_WINDOW)]
    # a cut input under the size rule's 2 GiB asks for the same engine
    stream = [] if size > AUTO_STREAM_BYTES else ["--stream"]
    _, wall_a, last, by_entry_a, rss_a = run_cli(
        tmp, ["recalibrate", src, "-o", cli_fq, "-k", str(k), "-c",
              f"{SCALE_COVERAGE:g}", "--interleaved", *stream], n)
    check_launches("command line at config 4 (streamed)", by_entry_a, {
        "hash_build": W, "hash_only": 2 * W, "bloom_probe_trust": W,
        "bloom_or_words": W, "bloom_probe_words": W,
        "walk_errors": sum(-(-m // DEFAULT_CHUNK_ROWS) for m in sizes),
        "bloom_probe_hashed": 0})

    # ---- (b) the resident route in process; filter B kept as built
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    need = resident_need_bytes(n, L, n * L, n * (L - k + 1), cfg)
    if need > free:
        raise AssertionError(f"resident need {need} B is over the "
                             f"card's free {free} B")
    spot = load_script("scripts/torch_oracle_spot.py")
    res_fq = os.path.join(tmp, "res.fq")
    t: dict = {}
    try:        # the peak resident set from here on (Linux: clear_refs 5)
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        rss_from = "the resident run"
    except OSError:
        rss_from = "the script's start"
    with spot.kept_resident_run() as kept:
        kernels.reset_launches()
        t0 = time.time()
        info = recalibrate_fastq([src], res_fq, cfg, interleaved=True,
                                 timings=t)
        torch.cuda.synchronize()
        wall_b = time.time() - t0
        by_entry_b = dict(kernels.ENTRY_LAUNCHES)
        rss_b = peak_rss_bytes()
        rss_all = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    check_launches("resident route at config 4", by_entry_b, {
        "bloom_probe_trust": 1, "bloom_probe_words": 1,
        "bloom_probe_hashed": 0, "hash_build": 1, "bloom_or_words": 1,
        "hash_only": 0, "walk_errors": -(-n // DEFAULT_CHUNK_ROWS)})
    peaks = {name[:-len("_peak_bytes")]: t.pop(name)
             for name in sorted(t) if name.endswith("_peak_bytes")}
    if info["num_reads"] != n or not same_file(cli_fq, res_fq):
        raise AssertionError("the command line's streamed output differs "
                             "from the resident route's")
    out_size = os.path.getsize(res_fq)
    devices = phase_devices_scale(tmp, src, res_fq, cfg, n)
    oracle = phase_oracle(spot, src, res_fq, kept, cfg, info)
    # the first FULL_READS reads' codes, for the kernel checks: every record
    # of the generator's FASTQ has the same size
    nr = min(FULL_READS, n)
    with open(src, "rb") as f:
        codes = extract_padded_arrays(parse_fastq_bytes(
            f.read(nr * (size // n))))[0]
    for p in (cli_fq, res_fq, src):
        os.remove(p)
    log(f"[scale] command line (streamed, {W} windows): {wall_a:.3f} s, "
        f"{n / wall_a:.0f} reads/s; resident route: {wall_b:.3f} s, "
        f"{n / wall_b:.0f} reads/s, need {need} B of {free} B free; "
        f"outputs equal byte for byte ({out_size} B)")
    log(f"[scale] command line launches by entry {json.dumps(by_entry_a)}"
        f"; resident {json.dumps(by_entry_b)}")
    log("[scale] resident seconds by stage: " + json.dumps(t))
    log("[scale] resident peak device bytes by stage: " + json.dumps(peaks)
        + " (pass 4's holds filter B, kept for the checks below)")

    # ---- the kernels against the run's filter B
    dev = torch.device(DEVICE)
    filt_b = kept["b"][0]
    del kept
    if filt_b.numel() * 32 != 1 << pb.log2_m:
        raise AssertionError(f"filter B has {filt_b.numel()} words, "
                             f"expected 2^{pb.log2_m} bits")
    h, W_ext = cfg.num_hashes, min(cfg.ext_cap or DEFAULT_EXT_CAP, k)
    cd = torch.from_numpy(codes).to(dev)
    del codes
    h1, word, _, _ = hash_cache_build(cd, 0, k, h, 0, 24)
    nwin = h1.numel()
    hits = tb.bloom_query_words(filt_b, h1, word)
    mm_probe = mismatches(hits, tb.bloom_query_words_plain(filt_b, h1,
                                                           word))
    probe_ms = cuda_ms(lambda: tb.bloom_query_words(filt_b, h1, word))
    probe_plain_ms = cuda_ms(
        lambda: tb.bloom_query_words_plain(filt_b, h1, word))
    block = u32_to_wide(h1) & ((1 << (pb.log2_m - 5)) - 1)
    probe_lib_ms = cuda_ms(lambda: filt_b[block])
    del block
    probe_bound = bound(nwin * 9 + filt_b.numel() * 4, nwin * 4)
    hit_share = float(hits.float().mean())
    ns = min(SCALE_SAMPLE, nr)
    err_s = infer_errors(filt_b, cd[:ns], k, h, cfg.ext_cap,
                         trusted0=hits[:ns])
    mm_sample = mismatches(err_s, infer_errors_plain(
        filt_b, cd[:ns], k, h, cfg.ext_cap, trusted0=hits[:ns]))
    wr = min(WALK_READS, nr)
    c_w, tr0 = cd[:wr], hits[:wr]
    err = infer_errors(filt_b, c_w, k, h, cfg.ext_cap, trusted0=tr0)
    torch.cuda.synchronize()
    t0 = time.time()
    err_plain = infer_errors_plain(filt_b, c_w, k, h, cfg.ext_cap,
                                   trusted0=tr0)
    torch.cuda.synchronize()
    walk_plain_ms = (time.time() - t0) * 1e3
    mm_chunk = mismatches(err, err_plain)
    walk_graph_ms = cuda_graph_ms(lambda: kernels.walk_errors(
        c_w, tr0, filt_b, k, W_ext, h))
    marks, outside = int(err.sum()), int((~tr0).sum())
    n_w = L - k + 1
    walk_bound = bound(wr * (L + n_w + L) + min(filt_b.numel() * 4,
                                                 marks * 3 * 4),
                       outside * 12 + marks * 3 * 90)
    if mm_probe or mm_sample or mm_chunk:
        raise AssertionError(f"at filter B of 2^{pb.log2_m} bits: probe "
                             f"{mm_probe}, walk {mm_sample} (sample) and "
                             f"{mm_chunk} (chunk) mismatches")
    del h1, word, hits, cd, err, err_plain, err_s, filt_b
    torch.cuda.empty_cache()
    log(f"[scale] at filter B of 2^{pb.log2_m} bits: walk_errors 0 "
        f"mismatches on the first {ns} reads and on {wr} reads ({marks} "
        f"bases marked), {walk_graph_ms:.4f} ms a chunk from a graph "
        f"(plain {walk_plain_ms:.1f} ms, bound {walk_bound[0]:.4g} ms by "
        f"{walk_bound[1]}); bloom_probe_words over {nwin} windows: 0 "
        f"mismatches, {hit_share:.4f} hit, {probe_ms:.4f} ms (plain "
        f"{probe_plain_ms:.3f}, packed[idx] {probe_lib_ms:.4f}, bound "
        f"{probe_bound[0]:.4g} by {probe_bound[1]})")
    log(f"[scale] host peak resident set (None: /proc has no VmHWM): "
        f"{made['peak_rss_bytes']} B (the data generator), {rss_a} B (the "
        f"command line), {rss_b} B (this process, since {rss_from}); this "
        f"process's ru_maxrss over the whole script {rss_all} B; "
        f"{smi_line()}")
    result = {"reads": n, "cut_from": job["asked"] if n != job["asked"]
              else None, "genome_len": genome_len, "fastq_bytes": size,
              "log2_m_a": pa.log2_m, "log2_m_b": pb.log2_m,
              "windows": n * n_w, "generate_s": made["generate_s"],
              "render_s": made["render_s"], "cli_wall_s": wall_a,
              "cli_reads_per_s": n / wall_a, "cli_stderr": last,
              "cli_launches_by_entry": by_entry_a,
              "resident_wall_s": wall_b,
              "resident_reads_per_s": n / wall_b,
              "resident_need_bytes": need, "free_bytes": free,
              "resident_timings": t, "resident_peak_device_bytes": peaks,
              "resident_launches_by_entry": by_entry_b,
              "walk_sample_reads": ns, "walk_chunk_reads": wr,
              "walk_marks": marks, "walk_graph_ms": walk_graph_ms,
              "walk_plain_ms": walk_plain_ms,
              "walk_bound_ms": walk_bound[0],
              "probe_windows": nwin, "probe_hit_share": hit_share,
              "probe_ms": probe_ms, "probe_plain_ms": probe_plain_ms,
              "probe_library_ms": probe_lib_ms,
              "probe_bound_ms": probe_bound[0],
              "generator_peak_rss_bytes": made["peak_rss_bytes"],
              "cli_peak_rss_bytes": rss_a, "resident_peak_rss_bytes": rss_b,
              "script_ru_maxrss_bytes": rss_all, "devices": devices,
              "oracle": oracle, "card": smi_line()}
    log("[scale] " + json.dumps(result))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=FULL_READS,
                    help="reads of the main-path dataset (default: full size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale-reads", type=int, default=SCALE_READS,
                    help="reads of the config 4 phase (0: skip it)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1

    from kbbq_tpu_torch.pipeline import RecalConfig
    from kbbq_tpu_torch.utils.synth import (arrays_to_fastq_bytes,
                                            make_arrays_fast, read_starts)

    t_start = time.time()

    def mark(phase):  # the run's timeline: seconds since the start
        log(f"[time] {phase} done at {time.time() - t_start:.1f} s")

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
    mark("kernels")
    torch.cuda.empty_cache()
    records += phase_sharded_kernels(arrays, cfg)
    mark("sharded_kernels")
    torch.cuda.empty_cache()
    fastq_bytes = arrays_to_fastq_bytes(arrays)

    tmp = tempfile.mkdtemp(prefix="kbbq_smoke_")
    job = None
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
        mark("golden to checkpoint")
        dev_by_rank, dev_launches = phase_devices(tmp, cfg, args.reads)
        mark("devices")
        sh_by_rank, sh_launches, sh_streamed = phase_sharded(tmp, cfg,
                                                             args.reads)
        mark("sharded")
        starts = read_starts(genome_len, read_len, args.reads, args.seed)
        bam, bam_streamed, bam_quals = phase_bam(tmp, arrays, starts, cfg)
        phase_resident_need(arrays, cfg)
        cram, cram_streamed = phase_cram(tmp, arrays, starts, cfg,
                                         bam_quals)
        mark("bam, cram")
        del bam_quals
        D = torch.cuda.device_count()
        if args.scale_reads:  # config 4's data, beside [multihost] and [cli]
            job = start_scale_data(args.scale_reads, args.seed)
        mh = phase_multihost(tmp, cfg, 2 if D >= 2 else 1,
                             max(1, D // 2) if D >= 2 else 1,
                             load="config 4's FASTQ written beside"
                             if job is not None else "")
        mh_by_rank = mh["runs"]["fastq, replicated"]["launches_by_rank"]
        mark("multihost")
        cli = phase_cli(tmp, cfg, args.seed, genome_len, {
            "fastq": launches, "fastq_stream": streamed, "bam": bam,
            "bam_stream": bam_streamed, "cram": cram, "reads": args.reads,
            "read_len": read_len})
        mark("cli")
        shutil.rmtree(tmp, ignore_errors=True)
        del arrays, true_err, starts
        torch.cuda.empty_cache()
        phase_scaling(args.reads)
        phase_config5()
        mark("scaling, config5")
        torch.cuda.empty_cache()
        scale = phase_scale(job) if job is not None else None
        mark("scale")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        stop_scale_data(job)

    for r in records:
        r["launches_streamed"] = streamed[r["entry"]]
        r["launches_bam"] = bam[r["entry"]]
        r["launches_bam_streamed"] = bam_streamed[r["entry"]]
        r["launches_cram"] = cram[r["entry"]]
        r["launches_cram_streamed"] = cram_streamed[r["entry"]]
        r["launches_cli"] = cli[r["entry"]]
        r["launches_devices"] = dev_launches[r["entry"]]
        r["launches_devices_by_rank"] = [c[r["entry"]] for c in dev_by_rank]
        r["launches_sharded"] = sh_launches[r["entry"]]
        r["launches_sharded_by_rank"] = [c[r["entry"]] for c in sh_by_rank]
        r["launches_sharded_streamed"] = sh_streamed[r["entry"]]
        r["launches_multihost_by_rank"] = [c.get(r["entry"], 0)
                                           for c in mh_by_rank]
        if scale is not None:
            r["launches_scale"] = \
                scale["resident_launches_by_entry"][r["entry"]]
            r["launches_scale_cli"] = scale["cli_launches_by_entry"][
                r["entry"]]
            r["launches_scale_devices_by_rank"] = [
                c[r["entry"]] for c in scale["devices"]["launches_by_rank"]]
            at_scale = {"bloom_probe_words": ("probe", "ms"),
                        "walk_errors": ("walk", "graph_ms")}.get(r["entry"])
            if at_scale:
                kind, key = at_scale
                r["scale_log2_m"] = scale["log2_m_b"]
                r[f"scale_{key}"] = scale[f"{kind}_{key}"]
                r["scale_plain_ms"] = scale[f"{kind}_plain_ms"]
                r["scale_bound_ms"] = scale[f"{kind}_bound_ms"]
                if kind == "probe":
                    r["scale_library_ms"] = scale["probe_library_ms"]
        r["launches"] = {"streamed": streamed, "sharded": sh_launches}.get(
            r.get("path"), launches)[r["entry"]]
    log(f"[done] {time.time() - t_start:.0f} s in all")
    print(json.dumps({"kernels": records}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The logic of kbbq_tpu_torch/csrc/kbbq_kernels.cu on the CPU.

A CUDA kernel has no interpret mode, but these kernels call nothing of the
CUDA library, so a host C++ compiler can build them against the stand-in
``csrc/host/cuda_runtime.h`` (one OS thread per CUDA thread, barriers for
__syncthreads and the warp functions).  The tests load that library with the
port's own ctypes binding, hand it CPU tensors, and hold every entry point
against its plain PyTorch version: tiles, ragged last tiles, base pointers
that are not 16-byte aligned, k = 32 and k < 17, reads with N, the fused
trust probe with T < k and tiles that had to be halved; the three modes of
the fused hash kernel (a warp per read: reads of every length against 32,
Ns at chunk edges, a read of 30,000 bases), the rule-only
trust entry point, and the round-based walk (walk_round) driven in rounds
as the hash-space-sharded layout drives it.  They say
nothing about the card (chip_smoke.py does) and skip where there is no g++.
Tolerance: exact equality.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from kbbq_tpu_torch import kernels
from kbbq_tpu_torch.ops import bloom as tbloom
from kbbq_tpu_torch.ops.hash_cache import hash_cache_chunk, hash_windows_plain
from kbbq_tpu_torch.ops.inference import (LocalExchange, infer_errors_plain,
                                          infer_errors_sharded)
from kbbq_tpu_torch.utils.synth import make_two_sided_reads

torch.set_num_threads(2)

CSRC = os.path.dirname(kernels.SOURCE)


def _split_top(text):
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(["
        depth -= ch in ")]"
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()]


def _host_source(cuda_source: str) -> str:
    """kernel<<<grid, threads, shared, stream>>>(args) -> LAUNCH((kernel),
    grid, threads, args), the kernel in parentheses because a template
    instance may hold commas; the shared-memory declaration is the
    header's."""
    def launch(m):
        grid, threads = _split_top(m.group(2))[:2]
        tail = ")" if m.group(3) else ", "
        return f"LAUNCH(({m.group(1)}), {grid}, {threads}{tail}"
    src = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\(\s*(\))?", launch,
                 cuda_source, flags=re.S)
    return src.replace("extern __shared__ uint4 smem4[];", "")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the kernels' host build needs a C++17 compiler")
    build = tmp_path_factory.mktemp("kernels_host")
    with open(kernels.SOURCE) as f:
        (build / "kernels_host.cpp").write_text(_host_source(f.read()))
    out = build / "libkernels_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", os.path.join(CSRC, "host"), "-o", str(out),
                    str(build / "kernels_host.cpp"), "-lpthread"],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    kernels._bind(lib)
    return lib


def _reads(rng, N, L, genome_len=4000, err=0.02, n_rate=0.01):
    """(error-free reads, the same with errors, Ns and corner rows)."""
    genome = rng.integers(0, 4, genome_len).astype(np.int8)
    start = rng.integers(0, genome_len - L, N)
    clean = genome[start[:, None] + np.arange(L)[None]]
    flip = rng.random(N) < 0.5
    clean[flip] = (3 - clean[flip])[:, ::-1]          # the other strand
    codes = clean.copy()
    e = rng.random((N, L)) < err
    codes[e] = (codes[e] + rng.integers(1, 4, int(e.sum()))) % 4
    codes[rng.random((N, L)) < n_rate] = 4
    if N > 8:
        codes[3, L // 2:] = 4                         # a short read's padding
        codes[4, :] = 4                               # all N
        codes[5] = rng.integers(0, 4, L)              # not from the genome
        codes[6, ::7] = (codes[6, ::7] + 1) % 4       # error-dense
    return clean, codes


HASH_CASES = [
    # N, L, k, first_id, row offset of the base pointer, threshold, and
    # whether Ns are planted at the first and last base of 32-base chunks
    (50, 60, 16, 0, 0, 0x3BBBBBBA, False),
    (33, 150, 32, 5, 1, 0x3BBBBBBA, False),
    (7, 40, 8, (1 << 31) + 3, 1, 0x80000000, False),
    (65, 90, 17, (1 << 32) - 30, 3, 0xFFFFFFFF, False),
    (20, 32, 32, 0, 0, 0, False),
    (9, 45, 31, 1 << 40, 2, 0x10000000, False),
    (40, 33, 1, 0, 0, 0x70000000, False),
    (5, 20, 32, 0, 0, 5, False),                      # L < k: no launch
    (12, 64, 32, 0, 1, 0x3BBBBBBA, True),             # L = 2·32, n = 33
    (12, 97, 31, 3, 2, 0x3BBBBBBA, True),             # L = 3·32 + 1
    (10, 128, 1, (1 << 32) + 9, 3, 0x70000000, True),  # k = 1, n = 4·32
    (2, 30_000, 32, 7, 1, 0x3BBBBBBA, True),          # a long read
]


def _hash_reads(case, seed):
    """The codes of a HASH_CASES entry, `off` rows into their tensor: reads
    with N (rows 3-6 corner rows where there are more than 8), and with
    `edges` an N at bases 0, 31, 32 and 63 of every other row and at the
    last base of every third."""
    N, L, k, _, off, _, edges = case
    rng = np.random.default_rng(seed)
    _, codes = _reads(rng, N + off, L, genome_len=max(4000, 2 * L),
                      n_rate=0.03)
    if edges:
        for b in (0, 31, 32, 63):
            if b < L:
                codes[::2, b] = 4
        codes[::3, L - 1] = 4
    return torch.from_numpy(codes)[off:]


def _hash_id(c):
    return f"N{c[0]}L{c[1]}k{c[2]}"


@pytest.mark.parametrize("case", HASH_CASES, ids=_hash_id)
def test_hash_build_logic_matches_plain(lib, case):
    N, L, k, first_id, off, thr, _ = case
    c = _hash_reads(case, N * L + k)
    n = max(L - k + 1, 0)
    ids = torch.arange(first_id, first_id + N, dtype=torch.int64)
    want = hash_cache_chunk(c, ids, k, 7, thr)
    want_f = tbloom.bloom_build_words_plain(*want, 16)
    packed = torch.zeros(1 << 11, dtype=torch.int32)
    h1 = torch.full((N, n), 77, dtype=torch.int32)
    word = h1.clone()
    keep = torch.ones((N, n), dtype=torch.bool)
    rc = lib.kbbq_hash_build(c.data_ptr(), packed.data_ptr(),
                             packed.numel() - 1, h1.data_ptr(),
                             word.data_ptr(), keep.data_ptr(), N, first_id,
                             L, k, 7, thr, None)
    assert rc == 0
    if n == 0:
        assert not packed.any()
        return
    assert torch.equal(h1, want[0])         # windows with an N included
    assert torch.equal(word, want[1])
    assert torch.equal(keep.view(torch.uint8), want[2].view(torch.uint8))
    assert torch.equal(packed, want_f)
    if N > 8:
        assert (word == 0).any() and (word != 0).any()
    # the kernel instance of a probe count other than the default 7
    want = hash_cache_chunk(c, ids, k, 3, thr)
    packed.zero_()
    assert lib.kbbq_hash_build(c.data_ptr(), packed.data_ptr(),
                               packed.numel() - 1, h1.data_ptr(),
                               word.data_ptr(), keep.data_ptr(), N, first_id,
                               L, k, 3, thr, None) == 0
    assert torch.equal(h1, want[0]) and torch.equal(word, want[1])
    assert torch.equal(keep.view(torch.uint8), want[2].view(torch.uint8))
    assert torch.equal(packed, tbloom.bloom_build_words_plain(*want, 16))


@pytest.mark.parametrize("case", HASH_CASES, ids=_hash_id)
def test_hash_only_mode_matches_plain(lib, case):
    """The hash-only mode of the fused entry point (passes 2 and 3 of the
    windowed engine): h1 and word of every window equal the plain hash
    pass's, on k = 32, 31, 17, k < 17 and k = 1, reads of every length
    against 32 (a multiple, one more, shorter than k, 30,000 bases), reads
    with N (at chunk edges too, and all N) and base pointers 1-3 rows into
    the codes.  Its C entry point
    takes no filter and no keep plane, so there is nothing of either it
    could touch; the (h1, word) planes are the fused build's, whatever the
    filter held.  The probe counts 3 and 9 take the kernel instance of a
    count known only at run time, 7 the unrolled one."""
    N, L, k, first_id, off, thr, _ = case
    c = _hash_reads(case, N * L + k + 1)
    n = max(L - k + 1, 0)
    want_h1, want_word, _ = hash_cache_chunk(
        c, torch.arange(first_id, first_id + N, dtype=torch.int64), k, 7,
        thr)
    assert len(lib.kbbq_hash_only.argtypes) == 8       # codes, h1, word, ...
    h1 = torch.full((N, n), 77, dtype=torch.int32)
    word = h1.clone()
    rc = lib.kbbq_hash_only(c.data_ptr(), h1.data_ptr(), word.data_ptr(), N,
                            L, k, 7, None)
    assert rc == 0
    assert torch.equal(h1, want_h1) and torch.equal(word, want_word)
    p1, pw = hash_windows_plain(c, k, 7, chunk_rows=7)
    assert torch.equal(p1, want_h1) and torch.equal(pw, want_word)
    if n:
        # the same planes as the fused build writes into a filter it fills
        packed = torch.zeros(1 << 11, dtype=torch.int32)
        b1, bw, bk = (torch.empty((N, n), dtype=torch.int32),
                      torch.empty((N, n), dtype=torch.int32),
                      torch.empty((N, n), dtype=torch.bool))
        assert lib.kbbq_hash_build(c.data_ptr(), packed.data_ptr(),
                                   packed.numel() - 1, b1.data_ptr(),
                                   bw.data_ptr(), bk.data_ptr(), N, first_id,
                                   L, k, 7, thr, None) == 0
        assert torch.equal(b1, h1) and torch.equal(bw, word)
        # other probe counts: the instance of a count known at run time
        for nh in (3, 9):
            assert lib.kbbq_hash_only(c.data_ptr(), h1.data_ptr(),
                                      word.data_ptr(), N, L, k, nh,
                                      None) == 0
            p1, pw = hash_windows_plain(c, k, nh)
            assert torch.equal(h1, p1) and torch.equal(word, pw)


@pytest.mark.parametrize("case", HASH_CASES, ids=_hash_id)
def test_hash_keep_mode_matches_plain(lib, case):
    """The keep mode of the fused entry point (pass 1 of the
    hash-space-sharded layout): h1, word and keep of every window equal the
    plain hash pass's (and ``ops.hash_cache.hash_keep``'s on the CPU), with
    no filter to touch."""
    from kbbq_tpu_torch.ops.hash_cache import hash_keep
    N, L, k, first_id, off, thr, _ = case
    c = _hash_reads(case, N * L + k + 2)
    n = max(L - k + 1, 0)
    want = hash_cache_chunk(
        c, torch.arange(first_id, first_id + N, dtype=torch.int64), k, 7,
        thr)
    h1 = torch.full((N, n), 77, dtype=torch.int32)
    word = h1.clone()
    keep = torch.full((N, n), 7, dtype=torch.uint8)
    assert len(lib.kbbq_hash_keep.argtypes) == 11      # no filter argument
    rc = lib.kbbq_hash_keep(c.data_ptr(), h1.data_ptr(), word.data_ptr(),
                            keep.data_ptr(), N, first_id, L, k, 7, thr, None)
    assert rc == 0
    assert torch.equal(h1, want[0]) and torch.equal(word, want[1])
    assert torch.equal(keep, want[2].to(torch.uint8))
    got = hash_keep(c, first_id, k, 7, thr, chunk_rows=5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the kernel instance of a probe count other than the default 7
    want = hash_cache_chunk(
        c, torch.arange(first_id, first_id + N, dtype=torch.int64), k, 3,
        thr)
    assert lib.kbbq_hash_keep(c.data_ptr(), h1.data_ptr(), word.data_ptr(),
                              keep.data_ptr(), N, first_id, L, k, 3, thr,
                              None) == 0
    assert torch.equal(h1, want[0]) and torch.equal(word, want[1])
    assert torch.equal(keep, want[2].to(torch.uint8))


@pytest.mark.parametrize("n", [1, 255, 3000, 10000])
def test_bloom_or_words_logic_matches_plain(lib, n):
    rng = np.random.default_rng(2)
    h1 = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32))
    word = torch.from_numpy(rng.integers(1, 2**31, n).astype(np.int32))
    half = n // 2                           # every insert comes twice
    h1[half:2 * half], word[half:2 * half] = h1[:half].clone(), word[:half].clone()
    keep = torch.from_numpy(rng.random(n) < 0.6)
    packed = torch.zeros(1 << 9, dtype=torch.int32)
    rc = lib.kbbq_bloom_or_words(packed.data_ptr(), packed.numel() - 1,
                                 h1.data_ptr(), word.data_ptr(),
                                 keep.data_ptr(), n, None)
    assert rc == 0
    assert torch.equal(packed, tbloom.bloom_build_words_plain(h1, word, keep,
                                                              14))
    hits = torch.zeros(n, dtype=torch.bool)
    assert lib.kbbq_bloom_probe_words(packed.data_ptr(), packed.numel() - 1,
                                      h1.data_ptr(), word.data_ptr(),
                                      hits.data_ptr(), n, None) == 0
    assert torch.equal(hits, tbloom.bloom_query_words_plain(packed, h1, word))
    assert hits[keep].all()


PROBE_CASES = [(n, off) for n in (1, 3, 255, 4097) for off in (0, 1, 2, 3)]


@pytest.mark.parametrize("hashed", [False, True], ids=["words", "hashed"])
@pytest.mark.parametrize("n,off", PROBE_CASES,
                         ids=lambda v: str(v))
def test_bloom_probe_logic_matches_plain(lib, hashed, n, off):
    """Both probe entry points at sizes around the groups of 4 windows, from
    base pointers 0-3 elements into their tensors (inputs 0, 4, 8, 12 and the
    output 0-3 bytes past a 16-byte boundary), with invalid windows (word
    0) among the cached pairs."""
    rng = np.random.default_rng(n * 4 + off)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, n + off).astype(np.int32))
    b = torch.from_numpy(rng.integers(-2**31, 2**31, n + off).astype(np.int32))
    if not hashed:
        b[rng.random(n + off) < 0.2] = 0
    packed = torch.from_numpy(
        (rng.integers(-2**31, 2**31, 1 << 6)
         | rng.integers(-2**31, 2**31, 1 << 6)).astype(np.int32))
    out = torch.full((n + off,), 7, dtype=torch.uint8)
    a_, b_, o_ = a[off:], b[off:], out[off:]
    if hashed:
        rc = lib.kbbq_bloom_probe_hashed(packed.data_ptr(), 63, a_.data_ptr(),
                                         b_.data_ptr(), o_.data_ptr(), n, 3,
                                         None)
        want = tbloom.bloom_query_rows_plain(packed, a_, b_, 3)
    else:
        rc = lib.kbbq_bloom_probe_words(packed.data_ptr(), 63, a_.data_ptr(),
                                        b_.data_ptr(), o_.data_ptr(), n, None)
        want = tbloom.bloom_query_words_plain(packed, a_, b_)
    assert rc == 0
    assert torch.equal(o_, want.to(torch.uint8))
    assert 0 < int(want.sum()) < n or n < 4
    assert (out[:off] == 7).all()           # nothing written before the base


def test_bloom_probe_incongruent_pointers_take_the_narrow_paths(lib):
    """h1 and word at different offsets modulo 16 (every window scalar), and
    an output that does not follow them modulo 4 (wide loads, byte
    stores)."""
    rng = np.random.default_rng(5)
    n = 1001
    a = torch.from_numpy(rng.integers(-2**31, 2**31, n + 3).astype(np.int32))
    b = torch.from_numpy(rng.integers(1, 2**31, n + 3).astype(np.int32))
    packed = torch.from_numpy(rng.integers(-2**31, 2**31, 64).astype(np.int32))
    for oa, ob, oo in ((1, 2, 0), (0, 0, 1), (3, 3, 2)):
        out = torch.full((n + 3,), 7, dtype=torch.uint8)
        a_, b_, o_ = a[oa:oa + n], b[ob:ob + n], out[oo:oo + n]
        assert lib.kbbq_bloom_probe_words(
            packed.data_ptr(), 63, a_.data_ptr(), b_.data_ptr(),
            o_.data_ptr(), n, None) == 0
        want = tbloom.bloom_query_words_plain(packed, a_, b_)
        assert torch.equal(o_, want.to(torch.uint8))
        assert (out[oo + n:] == 7).all() and (out[:oo] == 7).all()


TRUST_CASES = [
    # N, L, k, T (None: k), tile_rows, threads (of the fused probe; the
    # rule-only entry point takes neither), row offset of the base
    # pointers, share of the error-free reads' windows that filter A holds
    (70, 36, 8, None, 32, 128, 0, 0.5),       # narrow: k = 8, L = 36
    (70, 36, 8, 5, 32, 128, 1, 0.5),          # T < k
    (40, 150, 32, None, 32, 256, 0, 0.4),     # k = 32, L = 150
    (41, 150, 32, 20, 8, 64, 1, 0.4),         # a halved tile, ragged, T < k
    (33, 60, 17, None, 5, 32, 3, 0.6),
    (20, 90, 31, 31, 1, 32, 2, 0.5),          # a read a block
    (9, 32, 32, None, 32, 64, 0, 0.7),        # n = 1
    (12, 300, 16, 12, 4, 96, 1, 0.4),         # n > 256: the masks' loop
    (25, 40, 1, None, 32, 128, 0, 0.5),       # k = 1
    (6, 20, 32, None, 32, 128, 0, 0.5),       # L < k: no launch
    (20, 95, 32, None, 8, 128, 1, 0.5),       # n = 2·32
    (20, 96, 32, 24, 8, 128, 0, 0.5),         # n = 2·32 + 1, T < k
    (16, 62, 31, 20, 16, 64, 2, 0.7),         # k = 31, n = 32, T < k
    (3, 3000, 32, None, 1, 64, 1, 0.5),       # a long read
]


@pytest.mark.parametrize(
    "case", TRUST_CASES,
    ids=lambda c: f"N{c[0]}L{c[1]}k{c[2]}T{c[3]}r{c[4]}t{c[5]}")
def test_bloom_probe_trust_logic_matches_plain(lib, case):
    from kbbq_tpu_torch.ops.trusted import trusted_from_cache_plain
    from kbbq_tpu_torch.oracle import coverage_thresholds
    N, L, k, T, rows, threads, off, cover = case
    rng = np.random.default_rng(N + L + k)
    clean, codes = _reads(rng, N + off, L, n_rate=0.02)
    ids = torch.arange(N + off, dtype=torch.int64)
    h1, word, _ = hash_cache_chunk(torch.from_numpy(clean), ids, k, 7, 0)
    held = (word != 0) & torch.from_numpy(
        rng.random(tuple(word.shape)) < cover)
    filt = tbloom.bloom_build_words_plain(h1, word, held, 16)
    h1, word, _ = hash_cache_chunk(torch.from_numpy(codes), ids, k, 7, 0)
    n = max(L - k + 1, 0)
    h1, word = h1[off:], word[off:]
    # the rule's table, capped at x so that short overlaps can be covered
    # too (n = 1 and k = 1 would else trust nothing)
    t = torch.minimum(torch.from_numpy(coverage_thresholds(0.2, k)),
                      torch.arange(k + 1).clamp(min=1)).to(torch.int32)
    out = torch.full((N, n), 7, dtype=torch.uint8)
    rc = lib.kbbq_bloom_probe_trust(
        filt.data_ptr(), filt.numel() - 1, h1.data_ptr(), word.data_ptr(),
        t.data_ptr(), out.data_ptr(), N, n, k, k if T is None else T, rows,
        threads, None)
    assert rc == 0
    if n == 0:
        return
    want = trusted_from_cache_plain(filt, h1, word, t, k, T)
    assert torch.equal(out, want.to(torch.uint8))
    if N > 8:
        assert 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize(
    "case", TRUST_CASES,
    ids=lambda c: f"N{c[0]}L{c[1]}k{c[2]}T{c[3]}r{c[4]}t{c[5]}")
def test_trust_rule_mode_matches_plain(lib, case):
    """The rule-only mode of the fused trust entry point (pass 2 of the
    hash-space-sharded layout): from a plane of hits made elsewhere, the
    trusted bytes of ``trusted_mask_batch`` (and of
    ``ops.trusted.trusted_from_hits`` on the CPU), which are the fused
    probe's own on the filter those hits came from."""
    from kbbq_tpu_torch.ops.trusted import (trusted_from_cache_plain,
                                            trusted_from_hits,
                                            trusted_mask_batch)
    from kbbq_tpu_torch.oracle import coverage_thresholds
    N, L, k, T, rows, threads, off, cover = case
    rng = np.random.default_rng(N + L + k)      # the fused probe's data
    clean, codes = _reads(rng, N + off, L, n_rate=0.02)
    ids = torch.arange(N + off, dtype=torch.int64)
    h1, word, _ = hash_cache_chunk(torch.from_numpy(clean), ids, k, 7, 0)
    held = (word != 0) & torch.from_numpy(
        rng.random(tuple(word.shape)) < cover)
    filt = tbloom.bloom_build_words_plain(h1, word, held, 16)
    h1, word, _ = hash_cache_chunk(torch.from_numpy(codes), ids, k, 7, 0)
    n = max(L - k + 1, 0)
    hits = tbloom.bloom_query_words_plain(filt, h1, word)[off:].contiguous()
    word = word[off:]
    t = torch.minimum(torch.from_numpy(coverage_thresholds(0.2, k)),
                      torch.arange(k + 1).clamp(min=1)).to(torch.int32)
    out = torch.full((N, n), 7, dtype=torch.uint8)
    TT = k if T is None else T
    assert len(lib.kbbq_trust_rule.argtypes) == 9      # no tile, no threads
    rc = lib.kbbq_trust_rule(hits.data_ptr(), word.data_ptr(), t.data_ptr(),
                             out.data_ptr(), N, n, k, TT, None)
    assert rc == 0
    if n == 0:
        return
    want = trusted_mask_batch(hits, word != 0, t, k, TT)
    assert torch.equal(out, want.to(torch.uint8))
    assert torch.equal(want, trusted_from_cache_plain(filt, h1[off:], word,
                                                      t, k, T))
    assert torch.equal(trusted_from_hits(hits, word, t, k, T, chunk_rows=7),
                       want)
    if N > 8:
        assert 0 < int(want.sum()) < want.numel()


def _walk_in_rounds(lib, codes, trusted0, filt, k, W, group=1 << 16,
                    owners=1):
    """The walk_round entry points driven as infer_errors_sharded drives
    them: walk_start, then per lane group walk_propose, the word test of its
    pairs by the plain test of `filt` (split among `owners` virtual owners,
    answered in the pairs' order) and walk_resolve, until the row says no
    lane walks -> (error marks, lanes by round, groups).  Checks the lane
    list walk_start writes, and that each group's pairs come grouped by
    owner, as many as its row counts."""
    N, L = codes.shape
    st = kernels.WalkState(N, L, k, "cpu", group, owners)
    shift = (filt.numel() // owners).bit_length() - 1
    assert lib.kbbq_walk_start(codes.data_ptr(), trusted0.data_ptr(),
                               st.pk.data_ptr(), st.fl.data_ptr(),
                               st.err.data_ptr(), st.cur.data_ptr(),
                               st.lists.data_ptr(), st.ctl.data_ptr(), N, L,
                               k, None) == 0
    walking = torch.nonzero(st.cur.view(-1) >= 0).view(-1)
    listed = st.lists[1, :int(st.ctl[3])]
    assert torch.equal(listed.sort().values.long(), walking)
    bound, groups = (st.group if N else 0), 0
    while True:
        assert lib.kbbq_walk_propose(
            st.pk.data_ptr(), st.fl.data_ptr(), st.cur.data_ptr(),
            st.lists.data_ptr(), st.ctl.data_ptr(), N, st.row.data_ptr(),
            st.route.data_ptr(), st.h1.data_ptr(), st.word.data_ptr(),
            st.pairs.data_ptr(), st.slot.data_ptr(), bound, st.group, owners,
            shift, L, k, 7, None) == 0
        groups += 1
        row = st.row.tolist()
        P, active = sum(row[:-1]), row[-1]
        if P == 0 and active == 0:
            return st.err, st.lanes_by_round(), groups
        assert 0 < P <= 3 * k * bound and active >= 1
        pairs = st.pairs[:P]
        own = ((pairs[:, 0].long() & 0xFFFFFFFF) >> shift) & (owners - 1)
        assert (own[1:] >= own[:-1]).all()
        assert torch.bincount(own, minlength=owners).tolist() == row[:-1]
        answers = tbloom.bloom_query_words_plain(
            filt, pairs[:, 0].contiguous(), pairs[:, 1].contiguous())
        answers = answers.to(torch.uint8)
        bound = min(st.group, active)
        assert lib.kbbq_walk_resolve(
            st.pk.data_ptr(), st.fl.data_ptr(), st.err.data_ptr(),
            st.cur.data_ptr(), st.lists.data_ptr(), st.ctl.data_ptr(), N,
            st.slot.data_ptr(), answers.data_ptr(), bound, L, k, W,
            None) == 0


WALK_CASES = [
    # N, L, k, W, tile_rows, threads, row offset, error rate, share of the
    # error-free reads' windows that the filter holds
    (200, 90, 32, 32, 32, 128, 0, 0.02, 1.0),
    (201, 90, 32, 8, 32, 64, 1, 0.02, 1.0),     # codes, trust 10, 11 mod 16
    (97, 60, 16, 16, 5, 32, 3, 0.02, 1.0),      # ragged tiles
    (64, 150, 32, 32, 64, 128, 0, 0.02, 1.0),
    (33, 60, 16, 8, 1, 32, 1, 0.02, 1.0),       # a read a block
    (40, 32, 32, 32, 32, 32, 0, 0.02, 1.0),     # L == k: one window
    (1, 90, 32, 32, 32, 128, 0, 0.02, 1.0),     # a single read
    (120, 50, 8, 8, 32, 128, 5, 0.02, 1.0),
    (90, 70, 17, 17, 7, 96, 2, 0.02, 1.0),      # 4-byte path of the copy
    (200, 150, 32, 32, 32, 128, 1, 0.01, 0.4),  # gaps: runs of failing breaks
    (150, 100, 16, 8, 16, 64, 0, 0.01, 0.6),
    (150, 150, 32, 32, 32, 128, 1, 0.15, 1.0),  # error-dense reads
    # walked against a filter with every bit set (cover < 0): a candidate's
    # extension then ends only at W, at the read's end or at an N
    (120, 90, 32, 32, 32, 128, 1, 0.03, -1.0),
    (100, 60, 16, 8, 16, 64, 0, 0.03, -1.0),
]


@pytest.mark.parametrize("case", WALK_CASES,
                         ids=lambda c: f"N{c[0]}L{c[1]}k{c[2]}W{c[3]}r{c[4]}")
def test_walk_errors_logic_matches_plain(lib, case):
    N, L, k, W, rows, threads, off, err, cover = case
    rng = np.random.default_rng(N + L + k + W)
    clean, codes = _reads(rng, N + off, L, err=err)
    ids = torch.arange(N + off, dtype=torch.int64)
    h1, word, _ = hash_cache_chunk(torch.from_numpy(clean), ids, k, 7, 0)
    held = (word != 0) & torch.from_numpy(rng.random((N + off, 1))
                                          < abs(cover))
    filt = tbloom.bloom_build_words_plain(h1, word, held, 18)
    big = torch.from_numpy(codes)
    h1, word, _ = hash_cache_chunk(big, ids, k, 7, 0)
    trust = tbloom.bloom_query_words_plain(filt, h1, word).contiguous()
    c, tr = big[off:], trust[off:]
    if cover < 0:
        filt = torch.full_like(filt, -1)
    want = infer_errors_plain(filt, c, k, 7, W, trusted0=tr)
    before = c.clone()
    got = torch.ones((N, L), dtype=torch.bool)
    rc = lib.kbbq_walk_errors(c.data_ptr(), tr.data_ptr(), filt.data_ptr(),
                              filt.numel() - 1, got.data_ptr(), N, L, k, W,
                              7, rows, threads, None)
    assert rc == 0
    assert torch.equal(c, before)           # codes are only read
    bad = (got.view(torch.uint8) != want.view(torch.uint8)).any(dim=1)
    assert not bad.any(), f"reads differ: {bad.nonzero()[:10, 0].tolist()}"
    if N > 8 and L > k:
        assert want.any()


ROUND_CASES = WALK_CASES[::2] + WALK_CASES[-1:] + [
    # reads shorter than k beside longer ones (row 3 holds L/2 bases)
    (96, 40, 24, 24, 0, 0, 0, 0.03, 1.0),
]
# lane groups and virtual owners: one group a round, several, one lane each
ROUND_DRIVES = [(1 << 16, 1), (7, 2), (5, 4)]


@pytest.mark.parametrize("drive", ROUND_DRIVES,
                         ids=lambda d: f"group{d[0]}owners{d[1]}")
@pytest.mark.parametrize("case", ROUND_CASES,
                         ids=lambda c: f"N{c[0]}L{c[1]}k{c[2]}W{c[3]}")
def test_walk_round_in_rounds_matches_plain(lib, case, drive):
    """The round-based walk (walk_start, then walk_propose, the word test
    and walk_resolve per lane group until no lane walks) against the plain
    walk, its plain version RoundWalkPlain and the one-launch walk_errors,
    on every other walk case (W < k, k < 17, L == k, a single read, reads
    with N, reads shorter than k, filters that leave runs of failing
    breaks, an all-set filter), with one group a round or several and the
    pairs grouped for 1, 2 or 4 owners; the rounds and their lane counts are
    the plain version's."""
    N, L, k, W, _, _, off, err, cover = case
    group, owners = drive
    N = min(N, 96)
    rng = np.random.default_rng(N + L + k + W + 1)
    clean, codes = _reads(rng, N + off, L, err=err)
    ids = torch.arange(N + off, dtype=torch.int64)
    h1, word, _ = hash_cache_chunk(torch.from_numpy(clean), ids, k, 7, 0)
    held = (word != 0) & torch.from_numpy(rng.random((N + off, 1))
                                          < abs(cover))
    filt = tbloom.bloom_build_words_plain(h1, word, held, 18)
    big = torch.from_numpy(codes)
    h1, word, _ = hash_cache_chunk(big, ids, k, 7, 0)
    trust = tbloom.bloom_query_words_plain(filt, h1, word).contiguous()
    c, tr = big[off:], trust[off:]
    if cover < 0:
        filt = torch.full_like(filt, -1)
    want = infer_errors_plain(filt, c, k, 7, W, trusted0=tr)
    got, rounds, groups = _walk_in_rounds(lib, c, tr, filt, k, W, group,
                                          owners)
    bad = (got != want).any(dim=1)
    assert not bad.any(), f"reads differ: {bad.nonzero()[:10, 0].tolist()}"
    ex = LocalExchange(filt)
    stats = {"walk_rounds": 0, "lanes_by_round": []}
    assert torch.equal(infer_errors_sharded(c, tr, ex, k, 7, W, group,
                                            stats), want)
    assert stats["lanes_by_round"] == rounds and ex.groups == groups
    one = torch.ones((N, L), dtype=torch.bool)
    assert lib.kbbq_walk_errors(c.data_ptr(), tr.data_ptr(), filt.data_ptr(),
                                filt.numel() - 1, one.data_ptr(), N, L, k, W,
                                7, 32, 128, None) == 0
    assert torch.equal(one, got)
    if N > 8 and L > k:
        assert want.any() and len(rounds) >= 2 and max(rounds) <= 2 * N
        assert groups >= len(rounds) + 1
        if group < 2 * N:
            assert groups > len(rounds) + 1     # a round took several


BOTH_SIDES_CASES = [
    # N, L, k, W, tile_rows, threads, launches
    (256, 36, 8, 8, 32, 128, 4),
    (256, 44, 16, 16, 32, 128, 4),
    (192, 40, 12, 6, 8, 64, 4),
    (64, 38, 10, 10, 2, 64, 4),
]


@pytest.mark.parametrize("case", BOTH_SIDES_CASES,
                         ids=lambda c: f"N{c[0]}L{c[1]}k{c[2]}W{c[3]}")
def test_walk_errors_commits_of_both_directions_share_a_word(lib, case):
    """Reads with a short anchor in the middle and errors on both sides of
    it within the first 32 bases: the right and the left walk of such a read
    run in different warps and commit into ONE 64-bit word of the packed
    working copy, so a commit must not rewrite the word's other bases.  A
    lost commit is a matter of timing and two OS threads seldom meet in the
    few instructions of a commit, so the launch is repeated here and, far
    more often and with real warps, by chip_smoke.py on the card."""
    N, L, k, W, rows, threads, launches = case
    clean, codes, left, right = make_two_sided_reads(N, L, k, seed=L * k)
    ids = torch.arange(N, dtype=torch.int64)
    h1, word, _ = hash_cache_chunk(torch.from_numpy(clean), ids, k, 7, 0)
    filt = tbloom.bloom_build_words_plain(h1, word, word != 0, 20)
    c = torch.from_numpy(codes)
    h1, word, _ = hash_cache_chunk(c, ids, k, 7, 0)
    tr = tbloom.bloom_query_words_plain(filt, h1, word).contiguous()
    want = infer_errors_plain(filt, c, k, 7, W, trusted0=tr)
    # the data does what the case is about: most reads are corrected on both
    # sides of the anchor, at bases of the same 32-base word
    both = (want[:, left[0]:left[1]].any(dim=1)
            & want[:, right[0]:right[1]].any(dim=1))
    assert int(both.sum()) > N // 2
    for _ in range(launches):
        got = torch.ones((N, L), dtype=torch.bool)
        rc = lib.kbbq_walk_errors(c.data_ptr(), tr.data_ptr(),
                                  filt.data_ptr(), filt.numel() - 1,
                                  got.data_ptr(), N, L, k, W, 7, rows,
                                  threads, None)
        assert rc == 0
        bad = (got.view(torch.uint8) != want.view(torch.uint8)).any(dim=1)
        assert not bad.any(), f"reads differ: {bad.nonzero()[:10, 0].tolist()}"


@pytest.mark.parametrize("case, group", [(c, 1 << 16)
                                         for c in BOTH_SIDES_CASES[:2]]
                         + [(BOTH_SIDES_CASES[0], 9)],
                         ids=lambda c: f"N{c[0]}L{c[1]}k{c[2]}W{c[3]}"
                         if isinstance(c, tuple) else f"group{c}")
def test_walk_round_serves_both_directions_in_one_round(lib, case, group):
    """The two-sided reads: one resolve launch commits both directions of a
    read into one 64-bit word of its packed copy (an atomic flip each), or
    two launches do when the lanes fall in different groups, and the marks
    are the plain walk's."""
    N, L, k, W = case[:4]
    clean, codes, left, right = make_two_sided_reads(N, L, k, seed=L * k + 1)
    ids = torch.arange(N, dtype=torch.int64)
    h1, word, _ = hash_cache_chunk(torch.from_numpy(clean), ids, k, 7, 0)
    filt = tbloom.bloom_build_words_plain(h1, word, word != 0, 20)
    c = torch.from_numpy(codes)
    h1, word, _ = hash_cache_chunk(c, ids, k, 7, 0)
    tr = tbloom.bloom_query_words_plain(filt, h1, word).contiguous()
    want = infer_errors_plain(filt, c, k, 7, W, trusted0=tr)
    both = (want[:, left[0]:left[1]].any(dim=1)
            & want[:, right[0]:right[1]].any(dim=1))
    assert int(both.sum()) > N // 2
    got, rounds, _ = _walk_in_rounds(lib, c, tr, filt, k, W, group)
    assert torch.equal(got, want)
    assert rounds[0] > N                    # both lanes of reads in a round


def test_tiles_that_do_not_fit_are_refused(lib):
    """A launch that cannot be made returns an error code and runs nothing;
    the wrapper's tile choice halves the rows until the tile fits."""
    assert lib.kbbq_walk_tile_bytes(150, 32, 32) < 48 * 1024
    assert lib.kbbq_walk_tile_bytes(150, 32, 1024) > kernels.MAX_SHARED_BYTES
    z = torch.zeros(16, dtype=torch.int32)
    assert lib.kbbq_walk_errors(z.data_ptr(), z.data_ptr(), z.data_ptr(), 15,
                                z.data_ptr(), 1024, 150, 32, 32, 7, 1024,
                                128, None) != 0
    assert lib.kbbq_walk_errors(z.data_ptr(), z.data_ptr(), z.data_ptr(), 15,
                                z.data_ptr(), 4, 150, 32, 32, 7, 4, 100,
                                None) != 0          # threads: whole warps
    rows = kernels._fit_tile_rows(lib.kbbq_walk_tile_bytes, 150, 32, 1024)
    assert lib.kbbq_walk_tile_bytes(150, 32, rows) <= \
        kernels.MAX_SHARED_BYTES < lib.kbbq_walk_tile_bytes(150, 32, 2 * rows)
    with pytest.raises(ValueError):
        kernels._fit_tile_rows(lib.kbbq_walk_tile_bytes, 400_000, 32, 32)
    # the fused trust probe: 32 reads of 150 bases fit, 1024 do not and are
    # refused; the wrapper's choice halves them until they fit
    def trust_bytes(L, k, rows):
        return lib.kbbq_trust_tile_bytes(L, k, rows, kernels.TRUST_THREADS)
    assert trust_bytes(150, 32, kernels.TRUST_TILE_ROWS) < 48 * 1024
    assert lib.kbbq_bloom_probe_trust(
        z.data_ptr(), 15, z.data_ptr(), z.data_ptr(), z.data_ptr(),
        z.data_ptr(), 1024, 119, 32, 32, 1024, 256, None) != 0
    assert lib.kbbq_bloom_probe_trust(
        z.data_ptr(), 15, z.data_ptr(), z.data_ptr(), z.data_ptr(),
        z.data_ptr(), 4, 119, 33, 33, 4, 256, None) != 0     # k > 32
    rows = kernels._fit_tile_rows(trust_bytes, 150, 32, 1024)
    assert trust_bytes(150, 32, rows) <= kernels.MAX_SHARED_BYTES \
        < trust_bytes(150, 32, 2 * rows)
    assert kernels._fit_tile_rows(trust_bytes, 10_000, 32, 32) < 32
    # the fused hash kernel and the rule-only trust stage nothing, so only
    # their arguments can be refused: k outside 1..32, no probe
    assert lib.kbbq_hash_only(z.data_ptr(), z.data_ptr(), z.data_ptr(), 4,
                              150, 33, 7, None) != 0
    assert lib.kbbq_hash_keep(z.data_ptr(), z.data_ptr(), z.data_ptr(),
                              z.data_ptr(), 4, 0, 150, 0, 7, 5, None) != 0
    assert lib.kbbq_hash_build(z.data_ptr(), z.data_ptr(), 15, z.data_ptr(),
                               z.data_ptr(), z.data_ptr(), 4, 0, 150, 32, 0,
                               5, None) != 0
    assert lib.kbbq_trust_rule(z.data_ptr(), z.data_ptr(), z.data_ptr(),
                               z.data_ptr(), 4, 119, 33, 33, None) != 0

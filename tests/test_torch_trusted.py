"""kbbq_tpu_torch.ops.trusted.trusted_from_cache — pass 2's trust decision
from the hash cache, the module that holds the fused entry point of the
probe kernel (bloom_probe_trust) — against the JAX package's pass 2 on the
CPU, where the dispatcher takes the kernel's plain PyTorch version.  The
reference is the body of kbbq_tpu/pipeline/resident.py::_pass2_dense_cached:
the cached word test against filter A, then
kbbq_tpu.ops.trusted.trusted_mask_batch.  Inputs come from a numpy seed.
Tolerance: exact equality (bools).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbbq_tpu.ops.trusted import trusted_mask_batch as jax_trusted_mask_batch
from kbbq_tpu.oracle.lighter import coverage_thresholds as jax_thresholds
from kbbq_tpu.pipeline.resident import _dense_finish, _pass1_kmers_slice

from kbbq_tpu_torch import kernels
from kbbq_tpu_torch.ops.trusted import (trusted_from_cache,
                                        trusted_from_cache_plain,
                                        trusted_mask_batch)
from kbbq_tpu_torch.oracle import coverage_thresholds
from kbbq_tpu_torch.state import convert

torch.set_num_threads(2)

ALPHA = 0.25
THRESHOLD = 0x40000000          # pass 1 keeps about a quarter of the windows


def _reads(rng, N, L, k, genome_len=600):
    """Reads from a small genome at high coverage, with errors, Ns, a read
    shorter than k, one barely longer and an all-N read."""
    genome = rng.integers(0, 4, genome_len).astype(np.int8)
    start = rng.integers(0, genome_len - L, N)
    codes = genome[start[:, None] + np.arange(L)[None]]
    e = rng.random((N, L)) < 0.02
    codes[e] = (codes[e] + rng.integers(1, 4, int(e.sum()))) % 4
    codes[rng.random((N, L)) < 0.01] = 4
    if N > 6:
        codes[3, max(k - 2, 1):] = 4
        codes[4, k + 1:] = 4
        codes[5, :] = 4
    return codes


def _jax_pass2(codes, k, T, log2_m):
    """(h1, word, filter A, trusted) as the JAX package computes them: the
    hash cache and the sampled dense build of pass 1, then per window the
    word test and the coverage rule of _pass2_dense_cached's body."""
    N, L = codes.shape
    n = L - k + 1
    ids = np.arange(N, dtype=np.uint32)
    h1, w, keep = _pass1_kmers_slice(
        jnp.asarray(codes), jnp.asarray(ids), jnp.uint32(THRESHOLD), k=k,
        num_hashes=7, B=N)
    rows_a = _dense_finish((h1,), (w,), (keep,), log2_m=log2_m)
    h1i, wi = h1.reshape(N, n), w.reshape(N, n)
    mask_a = jnp.uint32((1 << (log2_m - 5)) - 1)
    valid = wi != 0
    hits = ((rows_a[(h1i & mask_a).astype(jnp.int32)] & wi) == wi) & valid
    t_table = jnp.asarray(jax_thresholds(ALPHA, k))
    tr = jax_trusted_mask_batch(hits, valid, t_table, k, T)
    return (np.asarray(h1i), np.asarray(wi), np.asarray(rows_a),
            np.asarray(tr))


def _port_inputs(h1, w, rows_a):
    th1, tword, _ = convert.hash_cache_from_numpy(h1, w, w != 0)
    return convert.bloom_from_numpy(rows_a), th1, tword


@pytest.mark.parametrize("log2_m", [10, 14, 20])
@pytest.mark.parametrize("k,T", [(8, None), (8, 5), (17, None), (17, 9),
                                 (31, None), (32, None), (32, 20)])
def test_trusted_from_cache_matches_jax_pass2(k, T, log2_m):
    rng = np.random.default_rng(k * 100 + log2_m)
    codes = _reads(rng, 64, 70, k)
    h1, w, rows_a, want = _jax_pass2(codes, k, T, log2_m)
    packed, th1, tword = _port_inputs(h1, w, rows_a)
    t = torch.from_numpy(coverage_thresholds(ALPHA, k))
    got = trusted_from_cache(packed, th1, tword, t, k, T)
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    # rows 3 and 5 have no valid window at all, so nothing to trust
    assert not want[3].any() and not want[5].any()
    if log2_m >= 14:
        assert want.any() and not want.all()


@pytest.mark.parametrize("chunk_rows", [1, 7, None])
def test_result_does_not_depend_on_the_chunk_size(chunk_rows):
    k, T = 17, None
    rng = np.random.default_rng(chunk_rows or 0)
    codes = _reads(rng, 40, 60, k)
    h1, w, rows_a, want = _jax_pass2(codes, k, T, 14)
    packed, th1, tword = _port_inputs(h1, w, rows_a)
    t = torch.from_numpy(coverage_thresholds(ALPHA, k))
    got = trusted_from_cache_plain(packed, th1, tword, t, k, T,
                                   chunk_rows=chunk_rows)
    assert np.array_equal(got.numpy(), want)
    assert want.any()


@pytest.mark.parametrize("N,L,k", [(5, 32, 32), (9, 8, 8), (1, 40, 17)])
def test_one_window_and_one_read(N, L, k):
    """n = 1 (reads of exactly k bases) and a single read."""
    rng = np.random.default_rng(N + L)
    codes = _reads(rng, N, L, k, genome_len=200)
    h1, w, rows_a, want = _jax_pass2(codes, k, None, 12)
    packed, th1, tword = _port_inputs(h1, w, rows_a)
    t = torch.from_numpy(coverage_thresholds(ALPHA, k))
    got = trusted_from_cache(packed, th1, tword, t, k)
    assert tuple(got.shape) == (N, L - k + 1)
    assert np.array_equal(got.numpy(), want)


def test_no_reads_and_no_windows():
    packed = torch.zeros(32, dtype=torch.int32)
    t = torch.from_numpy(coverage_thresholds(ALPHA, 16))
    for shape in ((0, 25), (6, 0), (0, 0)):
        x = torch.zeros(shape, dtype=torch.int32)
        got = trusted_from_cache(packed, x, x, t, 16)
        assert got.dtype == torch.bool and tuple(got.shape) == shape


def test_out_is_written_in_place_and_returned():
    k = 17
    rng = np.random.default_rng(3)
    codes = _reads(rng, 30, 60, k)
    h1, w, rows_a, want = _jax_pass2(codes, k, None, 14)
    packed, th1, tword = _port_inputs(h1, w, rows_a)
    t = torch.from_numpy(coverage_thresholds(ALPHA, k))
    flag = torch.ones(th1.shape, dtype=torch.bool)      # stale keep bits
    got = trusted_from_cache(packed, th1, tword, t, k, out=flag)
    assert got is flag
    assert np.array_equal(flag.numpy(), want)
    assert torch.equal(trusted_from_cache_plain(packed, th1, tword, t, k),
                       flag)


def test_plain_version_is_the_word_test_then_the_rule():
    """trusted_from_cache_plain against its two parts called by hand."""
    from kbbq_tpu_torch.ops.bloom import bloom_query_words_plain
    k = 8
    rng = np.random.default_rng(11)
    codes = _reads(rng, 50, 36, k, genome_len=300)
    h1, w, rows_a, want = _jax_pass2(codes, k, 6, 12)
    packed, th1, tword = _port_inputs(h1, w, rows_a)
    t = torch.from_numpy(coverage_thresholds(ALPHA, k))
    hits = bloom_query_words_plain(packed, th1, tword)
    by_hand = trusted_mask_batch(hits, tword != 0, t, k, 6)
    assert torch.equal(by_hand, trusted_from_cache_plain(packed, th1, tword,
                                                         t, k, 6))
    assert np.array_equal(by_hand.numpy(), want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """kernels.bloom_probe_trust launches its kernel or raises: handed CPU
    tensors it must not fall back to anything, and counts nothing."""
    packed = torch.zeros(64, dtype=torch.int32)
    x = torch.zeros((4, 9), dtype=torch.int32)
    t = torch.ones(9, dtype=torch.int32)
    before = dict(kernels.ENTRY_LAUNCHES)
    with pytest.raises(ValueError):
        kernels.bloom_probe_trust(packed, x, x, t, 8, 8)
    with pytest.raises(ValueError):
        kernels.bloom_probe_trust(packed, x, x, t, 8, 8,
                                  out=torch.zeros((4, 9), dtype=torch.bool))
    with pytest.raises(ValueError):
        kernels.bloom_probe_words(packed, x, x,
                                  out=torch.zeros((4, 9), dtype=torch.bool))
    assert kernels.ENTRY_LAUNCHES == before
    assert before["bloom_probe_trust"] == 0

"""kbbq_tpu_torch.ops.bloom — the module that holds the probe kernel
(bloom_probe) and the build kernel (bloom_or_words) — against the JAX
package on the CPU, where the port's wrappers take the kernels' plain
PyTorch versions.  The probe is held against both forms of the JAX
package: the XLA query and the Pallas probe kernel in interpret mode.
Tolerance: exact equality (bools and 32-bit words).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbbq_tpu.ops.bloom import (bloom_insert, bloom_query_rows, bloom_rows,
                                bloom_rows_dense, probe_words)
from kbbq_tpu.ops.kmers import canonical_kmers_batch, kmer_hashes
from kbbq_tpu.ops.pallas_bloom import bloom_query_rows_pallas

from kbbq_tpu_torch.ops import bloom as tbloom
from kbbq_tpu_torch.ops import kmers as tkm
from kbbq_tpu_torch.state import convert

# the suite runs with several worker processes: keep torch's intra-op pool
# small so the workers do not oversubscribe the cores
torch.set_num_threads(2)


def t32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32)
                            .copy())


def u32(t):
    return t.numpy().view(np.uint32)


def _batch(k, seed=5, B=64, L=100):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = 4
    hi, lo, valid = canonical_kmers_batch(jnp.asarray(codes), k)
    keep = jnp.asarray(rng.random((B, L - k + 1)) < 0.5) & valid
    return codes, hi, lo, valid, keep


@pytest.mark.parametrize("shape", [(64, 85), (64, 4, 8), (3,), (1, 1)])
def test_probe_matches_xla_and_pallas(shape):
    rng = np.random.default_rng(8)
    hi = rng.integers(0, 2**32, shape, dtype=np.uint32)
    lo = rng.integers(0, 2**32, shape, dtype=np.uint32)
    slots = (rng.random(1 << 16) < 0.3).astype(np.uint8)
    packed = bloom_rows(jnp.asarray(slots))
    want = np.asarray(bloom_query_rows(packed, jnp.asarray(hi),
                                       jnp.asarray(lo), 7))
    want_pl = np.asarray(bloom_query_rows_pallas(
        packed, jnp.asarray(hi), jnp.asarray(lo), 7, interpret=True))
    tpacked = convert.bloom_from_numpy(np.asarray(packed))
    got = tbloom.bloom_query_rows(tpacked, t32(hi), t32(lo), 7)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), want_pl)
    assert want.any() and not want.all() or len(shape) == 1 or shape == (1, 1)


@pytest.mark.parametrize("k", [16, 31, 32])
def test_probe_full_windows(k):
    """All windows of a batch, filter built from the batch's own k-mers."""
    codes, hi, lo, valid, keep = _batch(k)
    packed = bloom_rows(bloom_insert(jnp.zeros(1 << 18, jnp.uint8), hi, lo,
                                     keep, 7))
    want = np.asarray(bloom_query_rows(packed, hi, lo, 7) & valid)
    want_pl = np.asarray(bloom_query_rows_pallas(packed, hi, lo, 7,
                                                 interpret=True) & valid)
    thi, tlo, tvalid = tkm.canonical_kmers_batch(torch.from_numpy(codes), k)
    tpacked = convert.bloom_from_numpy(np.asarray(packed))
    got = (tbloom.bloom_query_rows(tpacked, thi, tlo, 7) & tvalid).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, want_pl)
    assert got[np.asarray(keep)].all()       # no false negatives


@pytest.mark.parametrize("k", [16, 31, 32])
def test_build_matches_sort_build_and_staging(k):
    """Plain build == bloom_rows_dense word for word == the packed view of
    the byte-staging insert."""
    codes, hi, lo, valid, keep = _batch(k, seed=9)
    log2_m = 18
    blk, w = probe_words(hi, lo, 7, log2_m)
    dense = np.asarray(bloom_rows_dense(blk.reshape(-1), w.reshape(-1),
                                        keep.reshape(-1), log2_m))
    staged = np.asarray(bloom_rows(
        bloom_insert(jnp.zeros(1 << log2_m, jnp.uint8), hi, lo, keep, 7)))
    assert np.array_equal(dense, staged)

    thi, tlo, tvalid = tkm.canonical_kmers_batch(torch.from_numpy(codes), k)
    h1, h2 = tkm.kmer_hashes(thi, tlo)
    word = tbloom.probe_word(h2, 7)
    tkeep = torch.from_numpy(np.asarray(keep))
    got = tbloom.bloom_build_words(h1, word, tkeep, log2_m)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert np.array_equal(convert.bloom_to_numpy(got), dense)
    # a pre-masked block index gives the same filter
    got2 = tbloom.bloom_build_words(t32(blk), word, tkeep, log2_m)
    assert torch.equal(got, got2)
    # OR commutes: the halves built apart, in the other order, OR to it
    half = tkeep.shape[0] // 2
    acc = torch.zeros(1 << (log2_m - 5), dtype=torch.int32)
    for sl in (slice(half, None), slice(0, half)):
        acc |= tbloom.bloom_build_words(h1[sl], word[sl], tkeep[sl], log2_m)
    assert torch.equal(acc, got)


@pytest.mark.parametrize("k", [16, 31, 32])
def test_cached_word_test_equals_hashed_query(k):
    codes, hi, lo, valid, keep = _batch(k, seed=12)
    thi, tlo, tvalid = tkm.canonical_kmers_batch(torch.from_numpy(codes), k)
    h1, h2 = tkm.kmer_hashes(thi, tlo)
    word = torch.where(tvalid, tbloom.probe_word(h2, 7),
                       torch.zeros_like(h2))
    for log2_m in (16, 18):     # one (h1, word) pair serves any filter size
        packed = tbloom.bloom_build_words(
            h1, word, torch.from_numpy(np.asarray(keep)), log2_m)
        cached = tbloom.bloom_query_words(packed, h1, word)
        hashed = tbloom.bloom_query_rows(packed, thi, tlo, 7) & tvalid
        assert torch.equal(cached, hashed)
        jpacked = jnp.asarray(convert.bloom_to_numpy(packed))
        want = np.asarray(bloom_query_rows(jpacked, hi, lo, 7) & valid)
        assert np.array_equal(cached.numpy(), want)
        assert not cached[~tvalid].any()


def test_hash_cache_matches_jax_pass1():
    """The port's per-chunk hash cache equals the JAX resident pipeline's
    _pass1_kmers_slice (h1, word, keep), pads and all."""
    from kbbq_tpu.pipeline.resident import _pass1_kmers_slice
    from kbbq_tpu_torch.ops.hash_cache import hash_cache_chunk

    k, B = 16, 32
    codes, *_ = _batch(k, seed=21, B=2 * B, L=60)
    codes[-3:] = 4                                   # padded rows
    ids = np.arange(2 * B, dtype=np.uint32)
    ids[-3:] = 0xFFFFFFFF
    thr = 0x3BBBBBBA
    jh1, jw, jkeep = _pass1_kmers_slice(
        jnp.asarray(codes), jnp.asarray(ids), jnp.uint32(thr), k=k,
        num_hashes=7, B=B)
    h1, word, keep = hash_cache_chunk(
        torch.from_numpy(codes), torch.from_numpy(ids.astype(np.int64)), k,
        7, thr)
    valid = np.asarray(jw).reshape(2 * B, -1) != 0
    assert np.array_equal(u32(word), np.asarray(jw).reshape(2 * B, -1))
    assert np.array_equal(keep.numpy(), np.asarray(jkeep).reshape(2 * B, -1))
    assert np.array_equal(u32(h1)[valid],
                          np.asarray(jh1).reshape(2 * B, -1)[valid])
    c1, cw, ck = convert.hash_cache_from_numpy(np.asarray(jh1),
                                               np.asarray(jw),
                                               np.asarray(jkeep))
    assert torch.equal(cw.view(2 * B, -1), word) and ck.dtype == torch.bool
    assert c1.dtype == torch.int32


def test_filters_carried_across_with_convert():
    rng = np.random.default_rng(4)
    slots = (rng.random(1 << 16) < 0.2).astype(np.uint8)
    packed = np.asarray(bloom_rows(jnp.asarray(slots)))
    a = convert.bloom_from_numpy(packed)
    b = convert.bloom_from_slots(slots)
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert np.array_equal(convert.bloom_to_numpy(a), packed)
    with pytest.raises(ValueError):
        convert.bloom_from_numpy(packed[:100])
    with pytest.raises(ValueError):
        convert.bloom_from_slots(slots[:33])
    with pytest.raises(ValueError):
        tbloom.bloom_query_words(a[:100], a[:4], a[:4])


def test_h1_h2_of_arbitrary_lanes_match():
    rng = np.random.default_rng(2)
    hi = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    lo = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    h1, h2 = kmer_hashes(jnp.asarray(hi), jnp.asarray(lo))
    t1, t2 = tkm.kmer_hashes(t32(hi), t32(lo))
    assert np.array_equal(u32(t1), np.asarray(h1))
    assert np.array_equal(u32(t2), np.asarray(h2))

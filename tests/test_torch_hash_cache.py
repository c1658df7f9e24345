"""kbbq_tpu_torch.ops.hash_cache — pass 1 as one function (hash cache of
every window + the sampled filter), the module behind the fused entry point
of the bloom_or_words kernel — on the CPU, where hash_cache_build takes the
plain PyTorch versions: against the JAX resident pipeline's
_pass1_kmers_slice (the hash cache) and _dense_finish (the filter).
Tolerance: exact equality (32-bit words and bools).  h1 of a window with
an N is compared among the port's own paths only: the JAX package leaves
it unspecified.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbbq_tpu.pipeline.resident import _dense_finish, _pass1_kmers_slice

from kbbq_tpu_torch import kernels
from kbbq_tpu_torch.ops import bloom as tbloom
from kbbq_tpu_torch.ops.hash_cache import hash_cache_build, hash_cache_chunk
from kbbq_tpu_torch.pipeline import resident
from kbbq_tpu_torch.state import convert

# the suite runs with several worker processes: keep torch's intra-op pool
# small so the workers do not oversubscribe the cores
torch.set_num_threads(2)

LOG2_M = 16
THRESHOLD = 0x3BBBBBBA


def u32(t):
    return t.numpy().view(np.uint32)


def _reads(k, seed, B=48, L=70):
    """Random reads with the corner rows: scattered Ns, a read shorter than
    k, one barely longer, an all-N read (as a padded row is)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = 4
    codes[3, max(k - 2, 1):] = 4
    codes[4, k + 1:] = 4
    codes[5, :] = 4
    return codes


def _jax_pass1(codes, first_id, k, log2_m=LOG2_M, threshold=THRESHOLD):
    B = codes.shape[0]
    ids = ((first_id + np.arange(B, dtype=np.int64)) & 0xFFFFFFFF).astype(
        np.uint32)
    h1, w, keep = _pass1_kmers_slice(
        jnp.asarray(codes), jnp.asarray(ids), jnp.uint32(threshold), k=k,
        num_hashes=7, B=B // 2)
    rows = _dense_finish((h1,), (w,), (keep,), log2_m=log2_m)
    n = codes.shape[1] - k + 1
    return (np.asarray(h1).reshape(B, n), np.asarray(w).reshape(B, n),
            np.asarray(keep).reshape(B, n), np.asarray(rows))


@pytest.mark.parametrize("first_id", [0, 1000, (1 << 31) - 5, (1 << 32) + 7])
@pytest.mark.parametrize("k", [8, 17, 32])
def test_hash_cache_build_matches_jax_pass1(k, first_id):
    """first_id: 0, > 0, a batch that crosses 2^31, and one past 2^32 (the
    sampling hash sees the low 32 bits of the ordinal)."""
    codes = _reads(k, seed=k)
    jh1, jw, jkeep, jrows = _jax_pass1(codes, first_id, k)
    h1, word, keep, packed = hash_cache_build(
        torch.from_numpy(codes), first_id, k, 7, THRESHOLD, LOG2_M)
    assert h1.dtype == word.dtype == packed.dtype == torch.int32
    assert keep.dtype == torch.bool and h1.is_contiguous()
    assert np.array_equal(u32(word), jw)
    assert np.array_equal(keep.numpy(), jkeep)
    valid = jw != 0
    assert np.array_equal(u32(h1)[valid], jh1[valid])
    assert np.array_equal(convert.bloom_to_numpy(packed), jrows)
    # the corner rows have no valid window at all, or exactly two
    assert not valid[3].any() and not valid[5].any()
    assert valid[4].sum() <= 2 and not keep.numpy()[~valid].any()
    assert jkeep.any() and not jkeep.all()


@pytest.mark.parametrize("chunk_rows", [1, 7, 48, 1000])
def test_hash_cache_build_does_not_depend_on_the_chunk(chunk_rows):
    codes = torch.from_numpy(_reads(17, seed=3))
    want = hash_cache_build(codes, 12345, 17, 7, THRESHOLD, LOG2_M)
    got = hash_cache_build(codes, 12345, 17, 7, THRESHOLD, LOG2_M,
                           chunk_rows=chunk_rows)
    for a, b in zip(got, want):
        assert torch.equal(a, b)        # h1 of windows with an N included
    # the same cache, row by row, from the plain hash pass itself
    ids = torch.arange(12345, 12345 + codes.shape[0], dtype=torch.int64)
    for a, b in zip(hash_cache_chunk(codes, ids, 17, 7, THRESHOLD), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("threshold", [0, 0x10000000, 0xFFFFFFFF])
def test_hash_cache_build_thresholds(threshold):
    """The compare is unsigned and inclusive: 2^32-1 keeps every valid
    window, 0 next to none."""
    codes = _reads(32, seed=9)
    _, jw, jkeep, jrows = _jax_pass1(codes, 77, 32, threshold=threshold)
    _, word, keep, packed = hash_cache_build(
        torch.from_numpy(codes), 77, 32, 7, threshold, LOG2_M)
    assert np.array_equal(keep.numpy(), jkeep)
    assert np.array_equal(convert.bloom_to_numpy(packed), jrows)
    if threshold == 0xFFFFFFFF:
        assert np.array_equal(keep.numpy(), jw != 0)
    if threshold == 0:
        assert keep.sum() <= 1


@pytest.mark.parametrize("shape", [(6, 10), (0, 40), (6, 16)])
def test_hash_cache_build_without_windows(shape):
    """Every read shorter than k (n = 0), no read at all, and L == k."""
    k = 16
    codes = torch.from_numpy(
        np.random.default_rng(1).integers(0, 4, shape).astype(np.int8))
    h1, word, keep, packed = hash_cache_build(codes, 0, k, 7, THRESHOLD,
                                              LOG2_M)
    n = max(shape[1] - k + 1, 0)
    for t in (h1, word, keep):
        assert tuple(t.shape) == (shape[0], n)
    assert tuple(packed.shape) == (1 << (LOG2_M - 5),)
    if n == 0 or shape[0] == 0:
        assert not packed.any()
    else:
        assert (word != 0).all()
        assert torch.equal(packed, tbloom.bloom_build_words(h1, word, keep,
                                                            LOG2_M))


def test_filter_from_the_cache_serves_the_cached_query():
    """The filter pass 1 returns answers the cached word test for every
    kept window (no false negatives) and no window with an N."""
    codes = torch.from_numpy(_reads(17, seed=5))
    h1, word, keep, packed = hash_cache_build(codes, 0, 17, 7, 0x80000000,
                                              LOG2_M)
    hits = tbloom.bloom_query_words(packed, h1, word)
    assert hits[keep].all() and not hits[word == 0].any()


def test_resident_pipeline_uses_the_dispatcher():
    """Pass 1 of the resident pipeline is hash_cache_build, and the
    pipeline itself holds no hash pass of its own."""
    assert resident.hash_cache_build is hash_cache_build
    assert not hasattr(resident, "hash_cache_chunk")


def test_fused_kernel_wrapper_takes_cuda_tensors_only():
    """The kernel's wrapper never takes a plain version's place: CPU tensors
    are refused, not hashed."""
    codes = torch.zeros((4, 40), dtype=torch.int8)
    packed = torch.zeros(1 << 11, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.hash_build(codes, packed, 0, 16, 7, THRESHOLD)
    with pytest.raises(ValueError):
        kernels.bloom_or_words(packed, packed[:4], packed[:4],
                               torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        kernels.hash_only(codes, 16, 7)
    assert set(kernels.ENTRY_LAUNCHES) == {
        "bloom_probe_hashed", "bloom_probe_words", "bloom_probe_trust",
        "bloom_or_words", "hash_build", "hash_only", "walk_errors"}
    assert not any(kernels.LAUNCHES.values())

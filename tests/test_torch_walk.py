"""kbbq_tpu_torch.ops.inference — the module that holds the walk kernel
(walk_errors) — on the CPU, where infer_errors takes the kernel's plain
round-based version: against the JAX package's XLA walk, against its Pallas
round kernel in interpret mode, and against the NumPy oracle read by read.
Tolerance: exact equality (bool error masks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbbq_tpu.io.batcher import ReadArrays
from kbbq_tpu.ops.bloom import bloom_rows
from kbbq_tpu.ops.inference import _longest_run_anchors as j_anchors
from kbbq_tpu.ops.inference import _next_break as j_next_break
from kbbq_tpu.ops.inference import infer_errors_batch
from kbbq_tpu.oracle import lighter as olight
from kbbq_tpu.utils.synth import make_dataset

from kbbq_tpu_torch.ops import bloom as tbloom
from kbbq_tpu_torch.ops import inference as tinf
from kbbq_tpu_torch.ops import kmers as tkm
from kbbq_tpu_torch.state import convert

from test_ops import _build_filters

ALPHA = 7.0 / 30.0

# the suite runs with several worker processes: keep torch's intra-op pool
# small so the workers do not oversubscribe the cores
torch.set_num_threads(2)


def _dataset(k, seed):
    """Reads with planted multi-error reads and Ns, plus the corner reads:
    shorter than k, barely longer than k, all-N, and one that is not from
    the genome (no trusted window)."""
    read_len = 60 if k <= 16 else 90
    ds = make_dataset(genome_len=1500, read_len=read_len, coverage=30.0,
                      error_rate=0.03, seed=seed, n_rate=0.01)
    _, bloom_b = _build_filters(ds, k, ALPHA)
    rng = np.random.default_rng(seed + 1000)   # not the genome's stream
    codes_l = [np.asarray(c).copy() for c in ds.codes]
    codes_l[3] = codes_l[3][:k + 3]
    codes_l[4] = codes_l[4][:k - 2]
    codes_l[5][:] = 4
    codes_l[6] = rng.integers(0, 4, read_len).astype(np.int8)
    codes_l[7][::7] = (codes_l[7][::7] + 1) % 4      # error-dense read
    quals_l = [np.asarray(q)[:len(c)] for q, c in zip(ds.quals, codes_l)]
    arrays = ReadArrays.from_lists(codes_l, quals_l, ds.rgs, ds.seconds)
    return codes_l, arrays, bloom_b


_CACHE = {}


def _cached(k):
    if k not in _CACHE:
        _CACHE[k] = _dataset(k, seed=23 + k)
    return _CACHE[k]


@pytest.mark.parametrize("k,ext_cap", [(16, None), (16, 16), (16, 8),
                                       (32, None), (32, 32), (32, 8)])
def test_infer_errors_matches_jax_and_oracle(k, ext_cap):
    codes_l, arrays, bloom_b = _cached(k)
    B = 96
    rows = bloom_rows(jnp.asarray(bloom_b.slots))
    want = np.asarray(infer_errors_batch(rows, jnp.asarray(arrays.codes[:B]),
                                         k, 7, ext_cap))
    packed = convert.bloom_from_slots(bloom_b.slots)
    got = tinf.infer_errors(packed, torch.from_numpy(arrays.codes[:B]), k, 7,
                            ext_cap).numpy()
    assert got.dtype == bool and got.shape == want.shape
    assert np.array_equal(got, want)
    assert got.sum() > 50
    bad = []
    for i, c in enumerate(codes_l[:B]):
        w = olight.infer_read_errors(c, k, bloom_b, ext_cap)
        if not np.array_equal(got[i, :len(c)], w) or got[i, len(c):].any():
            bad.append(i)
    assert not bad, f"reads disagree with the oracle: {bad[:10]}"
    # the corner reads mark nothing
    assert not got[4].any() and not got[5].any() and not got[6].any()


@pytest.mark.parametrize("k", [16, 32])
def test_infer_errors_matches_pallas_round_kernel(k):
    """Against the Pallas walk round kernel, interpreted on the CPU."""
    _, arrays, bloom_b = _cached(k)
    rows = bloom_rows(jnp.asarray(bloom_b.slots))
    codes = arrays.codes[:64]
    want = np.asarray(infer_errors_batch(rows, jnp.asarray(codes), k, 7,
                                         use_pallas=True))
    packed = convert.bloom_from_numpy(np.asarray(rows))
    got = tinf.infer_errors(packed, torch.from_numpy(codes), k, 7).numpy()
    assert np.array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("k", [16, 32])
def test_trusted0_and_row_chunks_do_not_change_the_walk(k):
    """Passing the cached initial trust, or walking the batch in row
    chunks, gives the same mask."""
    _, arrays, bloom_b = _cached(k)
    packed = convert.bloom_from_slots(bloom_b.slots)
    codes = torch.from_numpy(arrays.codes)
    whole = tinf.infer_errors(packed, codes, k, 7)
    hi, lo, valid = tkm.canonical_kmers_batch(codes, k)
    h1, h2 = tkm.kmer_hashes(hi, lo)
    word = torch.where(valid, tbloom.probe_word(h2, 7), torch.zeros_like(h2))
    tr0 = tbloom.bloom_query_words(packed, h1, word)
    assert torch.equal(tinf.infer_errors(packed, codes, k, 7, trusted0=tr0),
                       whole)
    parts = [tinf.infer_errors(packed, codes[s:s + 37], k, 7,
                               trusted0=tr0[s:s + 37])
             for s in range(0, codes.shape[0], 37)]
    assert torch.equal(torch.cat(parts), whole)
    assert not codes.ne(torch.from_numpy(arrays.codes)).any()  # untouched


def test_empty_filter_and_short_reads_mark_nothing():
    codes = torch.from_numpy(
        np.random.default_rng(0).integers(0, 4, (8, 40)).astype(np.int8))
    empty = torch.zeros(1 << 11, dtype=torch.int32)
    assert not tinf.infer_errors(empty, codes, 16, 7).any()
    full = torch.full((1 << 11,), -1, dtype=torch.int32)
    assert not tinf.infer_errors(full, codes, 16, 7).any()   # all trusted
    out = tinf.infer_errors(full, codes[:, :10], 16, 7)      # L < k
    assert tuple(out.shape) == (8, 10) and not out.any()


def test_anchors_and_next_break_match():
    rng = np.random.default_rng(6)
    tr = rng.random((200, 45)) < 0.6
    tr[0] = False
    tr[1] = True
    tr[2, :] = [i % 2 == 0 for i in range(45)]       # ties: leftmost
    tr[3, :10] = True
    tr[3, 10] = False
    tr[3, 11:21] = True                              # tie of two long runs
    a, b, has = (np.asarray(v) for v in j_anchors(jnp.asarray(tr)))
    ta, tb, thas = tinf._longest_run_anchors(torch.from_numpy(tr))
    assert np.array_equal(thas.numpy(), has)
    assert np.array_equal(ta.numpy()[has], a[has])
    assert np.array_equal(tb.numpy()[has], b[has])
    for i in range(tr.shape[0]):
        s, e = olight._longest_true_run(tr[i])
        if s >= 0:
            assert (int(ta[i]), int(tb[i])) == (s, e)
    valid = rng.random(tr.shape) < 0.9
    x = rng.integers(0, 46, 200).astype(np.int32)
    want = np.asarray(j_next_break(jnp.asarray(tr), jnp.asarray(valid),
                                   jnp.asarray(x), 45))
    got = tinf._next_break(torch.from_numpy(tr), torch.from_numpy(valid),
                           torch.from_numpy(x.astype(np.int64)), 45)
    assert np.array_equal(got.numpy(), want)
    # the mirrored search of the left walk
    back = tinf._prev_break(torch.from_numpy(tr[:, ::-1].copy()),
                            torch.from_numpy(valid[:, ::-1].copy()),
                            torch.from_numpy(44 - x.astype(np.int64)))
    assert np.array_equal(np.where(want < 45, 44 - want, -1), back.numpy())


def _contract_case(name):
    """Batches at the edges of the walk's contract: (k, codes int8 [B, L])."""
    k = 32 if name == "k32_one_window" else 16
    codes_l, arrays, _ = _cached(k)
    L = arrays.codes.shape[1]
    rng = np.random.default_rng(99)
    if name == "ragged_batch":          # 97 reads: no multiple of any tile
        return k, arrays.codes[:97]
    if name == "single_read":           # the first read with a mark, alone
        _, _, bloom_b = _cached(k)
        i = next(i for i in range(8, len(codes_l)) if olight.infer_read_errors(
            codes_l[i], k, bloom_b).any())
        return k, arrays.codes[i:i + 1]
    if name == "no_trusted_window":
        return k, rng.integers(0, 4, (5, L)).astype(np.int8)
    # error-free reads of the same genome (the generator draws the genome
    # first, so the seed fixes it whatever the error rate)
    clean = make_dataset(genome_len=1500, read_len=L, coverage=2.0,
                         error_rate=0.0, seed=23 + k)
    codes = np.stack([np.asarray(c) for c in clean.codes]).astype(np.int8)
    if name == "left_walk_only":        # one wrong base near the start
        codes[:, 2] = (codes[:, 2] + 1) % 4
        return k, codes
    assert name == "k32_one_window"     # L == k: a single window per read
    codes = codes[:, :32].copy()
    codes[::3, 31] = (codes[::3, 31] + 2) % 4    # untrusted: no anchor
    return k, codes


@pytest.mark.parametrize("name", ["ragged_batch", "single_read",
                                  "left_walk_only", "no_trusted_window",
                                  "k32_one_window"])
def test_walk_contract_cases(name):
    """What every version of the walk must give at the edges of its
    contract: the oracle's marks read by read, and the JAX package's."""
    k, codes = _contract_case(name)
    _, _, bloom_b = _cached(k)
    packed = convert.bloom_from_slots(bloom_b.slots)
    got = tinf.infer_errors(packed, torch.from_numpy(codes.copy()), k,
                            7).numpy()
    assert got.dtype == bool and got.shape == codes.shape
    want = np.stack([olight.infer_read_errors(c, k, bloom_b) for c in codes])
    assert np.array_equal(got, want)
    rows = bloom_rows(jnp.asarray(bloom_b.slots))
    assert np.array_equal(got, np.asarray(
        infer_errors_batch(rows, jnp.asarray(codes), k, 7)))
    if name == "left_walk_only":
        # in most reads the planted base is the one mark (the rest lie on
        # stretches of the genome that the filter does not cover)
        assert (got[:, 2] & (got.sum(axis=1) == 1)).sum() > got.shape[0] // 2
    if name in ("no_trusted_window", "k32_one_window"):
        assert not got.any()
    if name in ("ragged_batch", "single_read"):
        assert got.any()


def test_walk_kernel_wrapper_takes_cuda_tensors_only():
    """The kernel's wrapper never takes a plain version's place: CPU tensors
    are refused, not walked."""
    from kbbq_tpu_torch import kernels
    codes = torch.zeros((4, 40), dtype=torch.int8)
    tr0 = torch.ones((4, 25), dtype=torch.bool)
    packed = torch.zeros(1 << 11, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.walk_errors(codes, tr0, packed, 16, 16, 7)

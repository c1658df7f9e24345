"""kbbq_tpu_torch.ops against kbbq_tpu.ops on the CPU: the same inputs, made
from a numpy seed, go through the JAX function and its counterpart in the
port (device="cpu").  Tolerance: exact equality — every compared quantity
is an integer or a bool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbbq_tpu.ops import bloom as jbloom
from kbbq_tpu.ops import covariate as jcov
from kbbq_tpu.ops import kmers as jkm
from kbbq_tpu.ops import recal as jrecal
from kbbq_tpu.ops import trusted as jtrusted
from kbbq_tpu.oracle import lighter as olight

from kbbq_tpu_torch.ops import bloom as tbloom
from kbbq_tpu_torch.ops import covariate as tcov
from kbbq_tpu_torch.ops import kmers as tkm
from kbbq_tpu_torch.ops import recal as trecal
from kbbq_tpu_torch.ops import trusted as ttrusted

KS = [16, 31, 32]

# the suite runs with several worker processes: keep torch's intra-op pool
# small so the workers do not oversubscribe the cores
torch.set_num_threads(2)


def t32(a):
    """uint32 numpy/jax array -> int32 torch tensor with the same bits."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32)
                            .copy())


def u32(t):
    return t.numpy().view(np.uint32)


def make_codes(seed, B=64, L=100, n_rate=0.02):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < n_rate] = 4  # sprinkle Ns
    return codes


def test_fmix32_matches():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(jkm.fmix32(jnp.asarray(x)))
    assert np.array_equal(u32(tkm.fmix32(t32(x))), want)


def test_wide_round_trip():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    w = tkm.u32_to_wide(t32(x))
    assert w.dtype == torch.int64 and np.array_equal(w.numpy(), x)
    assert np.array_equal(u32(tkm.wide_to_u32(w)), x)


@pytest.mark.parametrize("k", KS)
def test_kmer_lanes_batch_matches(k):
    codes = make_codes(5 + k)
    want = [np.asarray(a) for a in jkm.kmer_lanes_batch(jnp.asarray(codes),
                                                        k)]
    got = tkm.kmer_lanes_batch(torch.from_numpy(codes), k)
    valid = want[4]
    assert np.array_equal(got[4].numpy(), valid)
    assert valid.any() and not valid.all()
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.int32
        assert np.array_equal(u32(g)[valid], w[valid])


@pytest.mark.parametrize("k", KS)
def test_canonical_kmers_batch_matches(k):
    codes = make_codes(7 + k)
    hi, lo, valid = (np.asarray(a) for a in
                     jkm.canonical_kmers_batch(jnp.asarray(codes), k))
    thi, tlo, tvalid = tkm.canonical_kmers_batch(torch.from_numpy(codes), k)
    assert np.array_equal(tvalid.numpy(), valid)
    assert np.array_equal(u32(thi)[valid], hi[valid])
    assert np.array_equal(u32(tlo)[valid], lo[valid])
    if k <= 16:
        assert not u32(thi)[valid].any()


def test_kmer_lanes_read_shorter_than_k():
    codes = torch.from_numpy(make_codes(1, B=4, L=10))
    out = tkm.kmer_lanes_batch(codes, 16)
    assert all(tuple(a.shape) == (4, 0) for a in out)


@pytest.mark.parametrize("k", KS)
def test_kmer_hashes_and_probe_word_match(k):
    codes = make_codes(11 + k)
    hi, lo, _ = jkm.canonical_kmers_batch(jnp.asarray(codes), k)
    h1, h2 = jkm.kmer_hashes(hi, lo)
    t1, t2 = tkm.kmer_hashes(t32(hi), t32(lo))
    assert np.array_equal(u32(t1), np.asarray(h1))
    assert np.array_equal(u32(t2), np.asarray(h2))
    for h in (1, 4, 7):
        want = np.asarray(jbloom.probe_word(h2, h))
        got = u32(tbloom.probe_word(t2, h))
        assert np.array_equal(got, want)
        assert got.all()    # never zero: 0 is the invalid-window sentinel
        off = np.asarray(jbloom.hash_offsets(h2, h))
        assert np.array_equal(tbloom.hash_offsets(t2, h).numpy(), off)
    for log2_m in (16, 23, 33):
        blk, off = jbloom.block_and_offsets(hi, lo, 7, log2_m)
        tblk, toff = tbloom.block_and_offsets(t32(hi), t32(lo), 7, log2_m)
        assert np.array_equal(tblk.numpy(), np.asarray(blk))
        assert np.array_equal(toff.numpy(), np.asarray(off))
        pb, pw = jbloom.probe_words(hi, lo, 7, log2_m)
        tb_, tw = tbloom.probe_words(t32(hi), t32(lo), 7, log2_m)
        assert np.array_equal(tb_.numpy(), np.asarray(pb))
        assert np.array_equal(u32(tw), np.asarray(pw))


@pytest.mark.parametrize("threshold", [0, 0x3BBBBBBA, 0xFFFFFFFF])
def test_sample_keep_mask_matches(threshold):
    ids = np.array([0, 1, 2, 77, 1_533_332, 0x7FFFFFFF, 0x80000001,
                    0xFFFFFFFF], dtype=np.uint32)
    want = np.asarray(jkm.sample_keep_mask(jnp.asarray(ids), 69,
                                           np.uint32(threshold)))
    got = tkm.sample_keep_mask(torch.from_numpy(ids.astype(np.int64)), 69,
                               threshold)
    assert np.array_equal(got.numpy(), want)
    # int32 patterns are accepted as well as int64 values
    got32 = tkm.sample_keep_mask(t32(ids), 69, threshold)
    assert np.array_equal(got32.numpy(), want)


@pytest.mark.parametrize("k", KS)
def test_trusted_mask_batch_matches(k):
    rng = np.random.default_rng(3 + k)
    codes = make_codes(13 + k)
    _, _, valid = jkm.canonical_kmers_batch(jnp.asarray(codes), k)
    valid = np.asarray(valid)
    hits = (rng.random(valid.shape) < 0.6) & valid
    hits[:8] = valid[:8]             # some fully covered reads
    alpha = 7.0 / 30.0
    t_table = olight.coverage_thresholds(alpha, k)
    for T in (None, k - 3):
        want = np.asarray(jtrusted.trusted_mask_batch(
            jnp.asarray(hits), jnp.asarray(valid),
            jnp.asarray(t_table, dtype=jnp.int32), k, T))
        got = ttrusted.trusted_mask_batch(
            torch.from_numpy(hits), torch.from_numpy(valid),
            torch.from_numpy(t_table), k, T)
        assert np.array_equal(got.numpy(), want)
        assert want.any()
    s, x = jtrusted.coverage_counts(jnp.asarray(hits), jnp.asarray(valid), k)
    ts, tx = ttrusted.coverage_counts(torch.from_numpy(hits),
                                      torch.from_numpy(valid), k)
    assert np.array_equal(ts.numpy(), np.asarray(s))
    assert np.array_equal(tx.numpy(), np.asarray(x))


def _cov_inputs(seed, B=64, L=100, num_rg=3):
    rng = np.random.default_rng(seed)
    codes = make_codes(seed)
    lens = rng.integers(L // 2, L + 1, B)
    mask = np.arange(L)[None, :] < lens[:, None]
    codes = np.where(mask, codes, 4).astype(np.int8)
    quals = rng.choice(np.array([2, 5, 6, 12, 20, 28, 37, 41], np.int8),
                       size=(B, L))
    quals = np.where(mask, quals, 0).astype(np.int8)
    rgs = (np.arange(B) % num_rg).astype(np.int32)
    seconds = np.arange(B) % 2 == 1
    errors = (rng.random((B, L)) < 0.05) & mask
    return codes, quals, mask, rgs, seconds, errors


@pytest.mark.parametrize("k", KS)   # three seeds; k only varies the data
def test_covariates_match(k):
    codes, quals, mask, rgs, seconds, errors = _cov_inputs(k)
    B, L = codes.shape
    cv = jcov.base_covariates(jnp.asarray(codes), jnp.asarray(quals),
                              jnp.asarray(mask), jnp.asarray(seconds))
    tcv = tcov.base_covariates(*(torch.from_numpy(a) for a in
                                 (codes, quals, mask, seconds)))
    for name in ("skip", "q", "cyc", "din"):
        assert np.array_equal(tcv[name].numpy(), np.asarray(cv[name])), name

    state = jcov.accumulate_covariates(
        jcov.new_covariate_state(3, L), *(jnp.asarray(a) for a in
                                          (codes, quals, mask, rgs, seconds,
                                           errors)))
    tstate = tcov.new_covariate_state(3, L, "cpu")
    # two row chunks, accumulated in place: order and chunking do not matter
    for sl in (slice(0, 23), slice(23, B)):
        out = tcov.accumulate_covariates(
            tstate, *(torch.from_numpy(a[sl].copy()) for a in
                      (codes, quals, mask, rgs, seconds, errors)))
        assert out is tstate
    for name in ("cyc_total", "cyc_errors", "din_total", "din_errors"):
        assert tstate[name].dtype == torch.int64
        assert np.array_equal(tstate[name].numpy(),
                              np.asarray(state[name])), name
    assert int(tstate["cyc_errors"].sum()) > 0

    # and the JAX package's host histogram over sparse error indices
    from kbbq_tpu.ops.covariate_host import _accumulate_numpy
    from kbbq_tpu.oracle.covariate import CovariateTables
    tables = CovariateTables(3, L)
    _accumulate_numpy(codes, quals, mask, rgs, seconds,
                      np.flatnonzero(errors), tables)
    assert np.array_equal(tstate["din_errors"].numpy(), tables.din_errors)
    assert np.array_equal(tstate["cyc_total"].numpy(), tables.cyc_total)


@pytest.mark.parametrize("k", KS)
def test_apply_recal_table_matches(k):
    codes, quals, mask, rgs, seconds, _ = _cov_inputs(100 + k)
    L = codes.shape[1]
    rng = np.random.default_rng(k)
    recal = rng.integers(1, 94, (3, 94, 2 * L, 17)).astype(np.int8)
    want = np.asarray(jrecal.apply_recal_table(
        jnp.asarray(recal), *(jnp.asarray(a) for a in
                              (codes, quals, mask, rgs, seconds))))
    got = trecal.apply_recal_table(
        torch.from_numpy(recal), *(torch.from_numpy(a) for a in
                                   (codes, quals, mask, rgs, seconds)))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    skip = ~mask | (codes == 4) | (quals < 6)
    assert np.array_equal(got.numpy()[skip], quals[skip])

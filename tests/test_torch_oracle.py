"""The port's NumPy oracle (``kbbq_tpu_torch.oracle``) against the JAX
package's (``kbbq_tpu.oracle``), function by function and end to end, on
inputs made from a seed with numpy; then the port's own pipeline and its
filter words against the port's oracle.  Exact equality everywhere: the
oracle is integer and boolean work, and the float64 delta math is the same
code.
"""

import numpy as np
import pytest

import kbbq_tpu.oracle as J
from kbbq_tpu.oracle import kmers as jkmers
from kbbq_tpu.oracle import lighter as jlighter
from kbbq_tpu.oracle.pipeline import ReadBatch as JReadBatch
from kbbq_tpu.utils.synth import make_dataset

import kbbq_tpu_torch.oracle as T
from kbbq_tpu_torch.oracle import kmers as tkmers
from kbbq_tpu_torch.oracle import lighter as tlighter
from kbbq_tpu_torch.oracle.pipeline import ReadBatch

KS = [16, 31, 32]


def _reads(seed, n=24, length=60, n_rate=0.03):
    """Reads of one random genome (so k-mers repeat), with substitutions
    and Ns, int8 codes."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 400).astype(np.int8)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, genome.size - length))
        r = genome[s:s + length].copy()
        sub = rng.random(length) < 0.02
        r[sub] = (r[sub] + 1) % 4
        r[rng.random(length) < n_rate] = 4
        out.append(r)
    return out


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_exports_match():
    want = {n for n in dir(J) if not n.startswith("_")}
    assert want <= set(dir(T)), want - set(dir(T))


@pytest.mark.parametrize("k", KS)
def test_kmer_layer(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    _same(T.fmix32(x), J.fmix32(x))
    _same(T.fmix32(7), J.fmix32(7))
    hi, lo = x[:250], x[250:]
    mask_hi = (1 << max(2 * k - 32, 0)) - 1
    _same(tkmers._shift_left_2(hi, lo, mask_hi),
          jkmers._shift_left_2(hi, lo, mask_hi))
    for codes in _reads(k):
        _same(T.canonical_kmers(codes, k), J.canonical_kmers(codes, k))
        h, l, _ = J.canonical_kmers(codes, k)
        _same(T.kmer_hashes(h, l), J.kmer_hashes(h, l))
        h1, h2 = J.kmer_hashes(h, l)
        for log2_m in (16, 20, 34):
            _same(tkmers.probe_positions(h1, h2, 7, log2_m),
                  jkmers.probe_positions(h1, h2, 7, log2_m))
    offs = np.arange(200, dtype=np.uint32)
    for rid in (0, 1, 2**31 + 5, 2**32 - 1):
        _same(T.sample_hash(np.uint32(rid), offs),
              J.sample_hash(np.uint32(rid), offs))
    for a in (0.05, 7 / 30, 1.0, 2.0):
        assert tkmers.alpha_threshold(a) == jkmers.alpha_threshold(a)
    seq = b"ACGTNacgtX"
    _same(T.encode_seq(seq), J.encode_seq(seq))
    assert T.decode_seq(T.encode_seq(seq)) == J.decode_seq(J.encode_seq(seq))


def _filters(k, reads, log2_m=18):
    """An OracleBloom of each package holding every valid k-mer of every
    other read."""
    mine = T.OracleBloom(T.BloomParams(log2_m, 7))
    theirs = J.OracleBloom(J.BloomParams(log2_m, 7))
    for codes in reads[::2]:
        hi, lo, valid = J.canonical_kmers(codes, k)
        mine.insert(hi, lo, mask=valid)
        theirs.insert(hi, lo, mask=valid)
    return mine, theirs


@pytest.mark.parametrize("k", KS)
def test_oracle_bloom(k):
    reads = _reads(k + 1)
    for log2_m in (18, 33):     # dense slots, and the set of positions
        mine, theirs = _filters(k, reads, log2_m)
        if mine.slots is not None:
            _same(mine.slots, theirs.slots)
        else:
            assert mine._set == theirs._set
        for codes in reads:
            hi, lo, _ = J.canonical_kmers(codes, k)
            _same(mine.query(hi, lo), theirs.query(hi, lo))
            _same(mine._positions(hi, lo), theirs._positions(hi, lo))
    p = T.BloomParams(20, 7)
    assert p.fpr(12345) == J.BloomParams(20, 7).fpr(12345)


@pytest.mark.parametrize("k", KS)
def test_lighter_layer(k):
    reads = _reads(k + 2)
    mine, theirs = _filters(k, reads)
    alpha = 0.4
    for codes in reads:
        _same(tlighter._window_kmer(codes, 3, k),
              jlighter._window_kmer(codes, 3, k))
        assert tlighter._query_window(mine, codes, 5, k) == \
            jlighter._query_window(theirs, codes, 5, k)
        _same(tlighter.coverage_mask(codes, k, mine, alpha),
              jlighter.coverage_mask(codes, k, theirs, alpha))
        for T_ in (None, k - 3):
            _same(T.trusted_kmer_mask(codes, k, mine, alpha, T_),
                  J.trusted_kmer_mask(codes, k, theirs, alpha, T_))
        for cap in (None, 4):
            _same(T.infer_read_errors(codes, k, mine, cap),
                  J.infer_read_errors(codes, k, theirs, cap))
    rng = np.random.default_rng(k)
    for _ in range(20):
        m = rng.random(int(rng.integers(0, 30))) < 0.6
        assert tlighter._longest_true_run(m) == \
            jlighter._longest_true_run(m)


def _batch(cls, ds):
    return cls(ds.codes, ds.quals, ds.rgs, ds.seconds)


def _same_run(mine, theirs):
    (q1, d1), (q2, d2) = mine, theirs
    assert len(q1) == len(q2)
    for a, b in zip(q1, q2):
        _same(a, b)
    for a, b in zip(d1["errors"], d2["errors"]):
        _same(a, b)
    for name in ("cyc_total", "cyc_errors", "din_total", "din_errors"):
        _same(getattr(d1["tables"], name), getattr(d2["tables"], name))
    _same(d1["recal_table"], d2["recal_table"])
    assert (d1["alpha"], d1["coverage"]) == (d2["alpha"], d2["coverage"])
    return d1


@pytest.mark.parametrize("k", KS)
def test_recalibrate_reads_equals_the_jax_oracle(k):
    """~200 reads with errors the walk corrects: new qualities, errors,
    tables and the Q' table equal."""
    ds = make_dataset(genome_len=800, read_len=60, coverage=15.0,
                      error_rate=0.01, seed=k, num_rg=2, paired=True,
                      n_rate=0.002)
    kw = dict(k=k, coverage=15.0)
    d = _same_run(T.recalibrate_reads(_batch(ReadBatch, ds),
                                      T.OracleConfig(**kw)),
                  J.recalibrate_reads(_batch(JReadBatch, ds),
                                      J.OracleConfig(**kw)))
    assert sum(int(e.sum()) for e in d["errors"]) > 0


def test_watch_list():
    """A read shorter than k, an all-N read, q < 6, an empty batch."""
    rng = np.random.default_rng(5)
    codes = [rng.integers(0, 4, 50).astype(np.int8),
             rng.integers(0, 4, 10).astype(np.int8),       # shorter than k
             np.full(40, 4, np.int8),                       # all N
             rng.integers(0, 4, 50).astype(np.int8)]
    quals = [rng.choice([2, 5, 12, 30], c.size).astype(np.int64)
             for c in codes]                                # q < 6 kept
    batch = (codes, quals, [0, 1, 0, 1], [False, True, False, True])
    got = _same_run(T.recalibrate_reads(ReadBatch(*batch),
                                        T.OracleConfig(k=16, coverage=4.0)),
                    J.recalibrate_reads(JReadBatch(*batch),
                                        J.OracleConfig(k=16, coverage=4.0)))
    q, _ = T.recalibrate_reads(ReadBatch(*batch),
                               T.OracleConfig(k=16, coverage=4.0))
    for c, qin, qout in zip(codes, quals, q):
        keep = (c == 4) | (qin < 6)
        assert np.array_equal(qout[keep], qin[keep])
    assert got["tables"].cyc_total.sum() == sum(
        int(((c != 4) & (qq >= 6)).sum()) for c, qq in zip(codes, quals))
    empty = ([], [], [], [])
    _same_run(T.recalibrate_reads(ReadBatch(*empty),
                                  T.OracleConfig(k=16, coverage=4.0)),
              J.recalibrate_reads(JReadBatch(*empty),
                                  J.OracleConfig(k=16, coverage=4.0)))


def test_the_ports_pipeline_equals_the_ports_oracle():
    """``run_pipeline(device="cpu")`` writes the port's oracle's qualities."""
    from kbbq_tpu_torch.io.batcher import ReadArrays
    from kbbq_tpu_torch.pipeline import RecalConfig, run_pipeline
    from kbbq_tpu_torch.utils.synth import make_dataset as t_make_dataset
    ds = t_make_dataset(genome_len=1500, read_len=70, coverage=20.0,
                        error_rate=0.01, seed=9, num_rg=2, paired=True,
                        n_rate=0.002)
    want, dbg = T.recalibrate_reads(_batch(ReadBatch, ds),
                                    T.OracleConfig(k=24, coverage=20.0))
    assert sum(int(e.sum()) for e in dbg["errors"]) > 0
    arrays = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    got = run_pipeline(arrays, RecalConfig(k=24, coverage=20.0),
                       device="cpu")
    assert np.array_equal(got, np.stack(want).astype(np.int8))


@pytest.mark.parametrize("k", KS)
def test_unpacked_filter_words_equal_the_oracles_filter(k):
    """Filter A as the port builds it (packed int32 words, the plain
    version of the fused hash + build), unpacked bit by bit, equals the
    oracle's own pass-1 inserts slot for slot."""
    import torch

    from kbbq_tpu_torch.ops.hash_cache import hash_cache_build
    ds = make_dataset(genome_len=600, read_len=50, coverage=10.0,
                      error_rate=0.01, seed=k, n_rate=0.002)
    codes = np.stack(ds.codes)
    alpha, log2_m = 0.3, 17
    thresh = T.alpha_threshold(alpha)
    *_, words = hash_cache_build(torch.from_numpy(codes), 0, k, 7,
                                 int(thresh), log2_m)
    slots = np.unpackbits(words.numpy().view("<u4").view(np.uint8),
                          bitorder="little")
    want = T.OracleBloom(T.BloomParams(log2_m, 7))
    for rid, c in enumerate(ds.codes):
        hi, lo, valid = T.canonical_kmers(c, k)
        keep = valid & (T.sample_hash(np.uint32(rid),
                                      np.arange(hi.size, dtype=np.uint32))
                        <= thresh)
        want.insert(hi, lo, mask=keep)
    assert want.slots.sum() > 0
    assert np.array_equal(slots, want.slots)

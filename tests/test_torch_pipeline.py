"""The slice as a whole: kbbq_tpu_torch's run_pipeline / recalibrate_fastq
on the CPU (device="cpu") against the JAX package's run_pipeline, the
committed goldens and the NumPy oracle.  Tolerance: exact equality (int8
qualities, output bytes).
"""

import dataclasses
import gzip
import os

import numpy as np
import pytest
import torch

from kbbq_tpu.io.batcher import ReadArrays as JReadArrays
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline.recalibrate import run_pipeline as j_run_pipeline
from kbbq_tpu.utils.synth import make_dataset as j_make_dataset
from kbbq_tpu.utils.synth import to_fastq_bytes as j_to_fastq_bytes

from kbbq_tpu_torch.io.batcher import ReadArrays
from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_fastq,
                                     run_pipeline)
from kbbq_tpu_torch.utils.synth import make_dataset

DATA = os.path.join(os.path.dirname(__file__), "data")

# the suite runs with several worker processes: keep torch's intra-op pool
# small so the workers do not oversubscribe the cores
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def synth():
    """3 read groups, paired, Ns: the JAX package's answer, computed once."""
    kw = dict(genome_len=1200, read_len=60, coverage=25.0, error_rate=0.02,
              seed=31, num_rg=3, paired=True, n_rate=0.01)
    ds = j_make_dataset(**kw)
    ja = JReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    want = np.asarray(j_run_pipeline(
        ja, JRecalConfig(k=16, coverage=25.0, batch_size=128)), np.int8)
    ds2 = make_dataset(**kw)                 # the port's own generator
    arrays = ReadArrays.from_lists(ds2.codes, ds2.quals, ds2.rgs,
                                   ds2.seconds)
    assert np.array_equal(arrays.codes, ja.codes)
    return arrays, want


@pytest.mark.parametrize("batch_size,chunk_rows",
                         [(128, None), (64, None), (128, 37), (64, 200)])
def test_run_pipeline_matches_jax(synth, batch_size, chunk_rows):
    """Two batch sizes and two chunk sizes: one answer, the JAX package's."""
    arrays, want = synth
    got = run_pipeline(arrays, RecalConfig(k=16, coverage=25.0,
                                           batch_size=batch_size),
                       device="cpu", chunk_rows=chunk_rows)
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert (got != arrays.quals).any()       # something was recalibrated


def test_run_pipeline_matches_jax_ext_cap_and_trust_threshold(synth):
    arrays, _ = synth
    ja = JReadArrays(arrays.codes, arrays.quals, arrays.mask, arrays.rgs,
                     arrays.seconds)
    kw = dict(k=16, coverage=25.0, batch_size=128, ext_cap=8,
              trust_threshold=14, min_log2_m=17)
    want = np.asarray(j_run_pipeline(ja, JRecalConfig(**kw)), np.int8)
    got = run_pipeline(arrays, RecalConfig(**kw), device="cpu")
    assert np.array_equal(got, want)


def test_timings_and_stage_names(synth):
    arrays, want = synth
    tm = {}
    got = run_pipeline(arrays, RecalConfig(k=16, coverage=25.0), device="cpu",
                       timings=tm)
    assert np.array_equal(got, want)
    assert list(tm) == ["route", "setup", "h2d", "pass1", "pass2", "pass3",
                        "deltas", "pass4", "counters", "spans"]


def test_tiny_fastq_matches_golden_bytes(tmp_path):
    out = tmp_path / "out.fq"
    info = recalibrate_fastq(os.path.join(DATA, "tiny.fq"), str(out),
                             RecalConfig(k=16, coverage=18.0, batch_size=64),
                             device="cpu")
    want = open(os.path.join(DATA, "tiny.recal.golden.fq"), "rb").read()
    assert out.read_bytes() == want
    assert info["read_groups"] == 1 and info["num_reads"] > 0


def test_midscale_matches_oracle_golden():
    """20,000 reads, k=32: the oracle's committed output (pattern of
    tests/test_midscale_golden.py)."""
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
                                           batch_size=2048), device="cpu",
                       chunk_rows=8192)
    assert np.array_equal(got, z["quals"])


def _small_fastq(tmp_path, name="in.fq", seed=17, low_q=False):
    ds = j_make_dataset(genome_len=800, read_len=50, coverage=20.0,
                        error_rate=0.02, seed=seed, n_rate=0.01)
    if low_q:
        rng = np.random.default_rng(seed)
        for q in ds.quals:
            q[rng.random(q.shape) < 0.1] = rng.integers(0, 6)
    p = tmp_path / name
    p.write_bytes(j_to_fastq_bytes(ds))
    return p, ds


def test_low_qualities_are_kept_verbatim(tmp_path):
    from kbbq_tpu_torch.io.fastq import extract_padded_arrays, read_fastq
    src, ds = _small_fastq(tmp_path, low_q=True)
    out = tmp_path / "out.fq"
    recalibrate_fastq(str(src), str(out), RecalConfig(k=16, coverage=20.0),
                      device="cpu")
    c0, q0, m0, _ = extract_padded_arrays(read_fastq(str(src)))
    c1, q1, m1, _ = extract_padded_arrays(read_fastq(str(out)))
    assert np.array_equal(c0, c1) and np.array_equal(m0, m1)
    low = m0 & (q0 < 6)
    assert low.sum() > 50
    assert np.array_equal(q1[low], q0[low])
    nbase = m0 & (c0 == 4)
    assert np.array_equal(q1[nbase], q0[nbase])
    assert (q1[m0 & ~low & ~nbase] != q0[m0 & ~low & ~nbase]).any()
    assert q1[m0].min() >= 0 and q1[m0].max() <= 93


def test_same_input_twice_gives_identical_bytes(tmp_path):
    src, _ = _small_fastq(tmp_path)
    outs = []
    for name in ("a.fq", "b.fq"):
        out = tmp_path / name
        recalibrate_fastq(str(src), str(out), RecalConfig(k=16,
                                                          coverage=20.0),
                          device="cpu")
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_gz_in_and_out_and_jax_bytes(tmp_path):
    """.gz on both sides decompresses to the plain run's bytes, which are
    the JAX package's bytes."""
    from kbbq_tpu.pipeline import recalibrate_fastq as j_recalibrate_fastq
    src, _ = _small_fastq(tmp_path)
    cfg = dict(k=16, coverage=20.0, batch_size=64)
    plain = tmp_path / "plain.fq"
    recalibrate_fastq(str(src), str(plain), RecalConfig(**cfg), device="cpu")
    jout = tmp_path / "jax.fq"
    j_recalibrate_fastq(str(src), str(jout), JRecalConfig(**cfg))
    assert plain.read_bytes() == jout.read_bytes()

    gz_in = tmp_path / "in.fq.gz"
    gz_in.write_bytes(gzip.compress(src.read_bytes()))
    gz_out = tmp_path / "out.fq.gz"
    recalibrate_fastq(str(gz_in), str(gz_out), RecalConfig(**cfg),
                      device="cpu")
    raw = gz_out.read_bytes()
    assert raw[:2] == b"\x1f\x8b"
    assert gzip.decompress(raw) == plain.read_bytes()
    gz_out2 = tmp_path / "out2.fq.gz"
    recalibrate_fastq(str(gz_in), str(gz_out2), RecalConfig(**cfg),
                      device="cpu")
    assert gz_out2.read_bytes() == raw       # no timestamp in the header


def test_two_inputs_are_two_read_groups(tmp_path):
    """Each input file is its own read group; one sink path concatenates."""
    from kbbq_tpu.pipeline import recalibrate_fastq as j_recalibrate_fastq
    a, _ = _small_fastq(tmp_path, "a.fq", seed=17)
    b, _ = _small_fastq(tmp_path, "b.fq", seed=18)
    cfg = dict(k=16, coverage=20.0, batch_size=64)
    out, jout = tmp_path / "o.fq", tmp_path / "j.fq"
    info = recalibrate_fastq([str(a), str(b)], str(out), RecalConfig(**cfg),
                             device="cpu")
    j_recalibrate_fastq([str(a), str(b)], str(jout), JRecalConfig(**cfg))
    assert info["read_groups"] == 2
    assert out.read_bytes() == jout.read_bytes()
    with pytest.raises(ValueError):
        recalibrate_fastq([str(a), str(b)], [str(out)], RecalConfig(**cfg),
                          device="cpu")


def test_reads_shorter_than_k_and_empty_input():
    """No read has a k-mer: qualities still pass through the covariate
    gather, as in the oracle."""
    from kbbq_tpu.oracle import OracleConfig, recalibrate_reads
    from kbbq_tpu.oracle.pipeline import ReadBatch
    ds = j_make_dataset(genome_len=300, read_len=12, coverage=8.0,
                        error_rate=0.02, seed=3)
    want, _ = recalibrate_reads(
        ReadBatch(ds.codes, ds.quals, ds.rgs, ds.seconds),
        OracleConfig(k=16, coverage=8.0))
    arrays = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    got = run_pipeline(arrays, RecalConfig(k=16, coverage=8.0), device="cpu")
    assert np.array_equal(got, np.stack(want).astype(np.int8))
    empty = ReadArrays(np.zeros((0, 12), np.int8), np.zeros((0, 12), np.int8),
                       np.zeros((0, 12), bool), np.zeros(0, np.int32),
                       np.zeros(0, bool))
    assert run_pipeline(empty, RecalConfig(k=16), device="cpu").shape == (0,
                                                                          12)


def test_recal_config_fields():
    """The JAX package's fields but walk_chunk and use_pallas; same
    defaults."""
    mine = {f.name: f.default for f in dataclasses.fields(RecalConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JRecalConfig)}
    assert set(theirs) - set(mine) == {"walk_chunk", "use_pallas"}
    assert set(mine) <= set(theirs)
    assert all(theirs[name] == v for name, v in mine.items())
    for total in (0, 10_000):
        for kw in ({}, {"coverage": 50.0}, {"genome_length": 100},
                   {"alpha": 0.3}):
            assert RecalConfig(**kw).resolve_alpha(total) == \
                JRecalConfig(**kw).resolve_alpha(total)

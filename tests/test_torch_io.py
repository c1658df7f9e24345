"""Host-side pieces of the port against the JAX package's: FASTQ IO (NumPy
paths), the synthetic generators, and the copied oracle functions whose
results are part of the bit-exact spec.  Tolerance: exact equality.
"""

import gzip
import os

import numpy as np
import pytest

from kbbq_tpu import constants as jconst
from kbbq_tpu.io import fastq as jfq
from kbbq_tpu.oracle import bloom as jobloom
from kbbq_tpu.oracle import gatk as jgatk
from kbbq_tpu.oracle import kmers as jokm
from kbbq_tpu.oracle import lighter as jolight
from kbbq_tpu.oracle import pipeline as jopipe
from kbbq_tpu.oracle.covariate import CovariateTables as JTables
from kbbq_tpu.utils import synth as jsynth

from kbbq_tpu_torch import constants as tconst
from kbbq_tpu_torch import oracle as toracle
from kbbq_tpu_torch.io import fastq as tfq
from kbbq_tpu_torch.state import convert
from kbbq_tpu_torch.utils import synth as tsynth

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_constants_are_equal():
    a = {k: v for k, v in vars(jconst).items() if k.isupper()}
    b = {k: v for k, v in vars(tconst).items() if k.isupper()}
    assert a == b and len(a) > 20
    c = np.array([-3, -1, 1, 2, 150])
    assert np.array_equal(jconst.cycle_to_index(c), tconst.cycle_to_index(c))


def _ragged_fastq():
    ds = jsynth.make_dataset(genome_len=500, read_len=40, coverage=6.0,
                             seed=2, n_rate=0.02)
    rng = np.random.default_rng(2)
    out = bytearray()
    for i, (c, q) in enumerate(zip(ds.codes, ds.quals)):
        m = int(rng.integers(1, 41))
        name = [f"r{i}/1", f"r{i}/2", f"r{i}/2 comment/1", f"r{i}/1\tx/2",
                f" lead{i}/2", f"r{i}/22", "/2", ""][i % 8]
        out += b"@" + name.encode() + b"\n"
        out += jokm.decode_seq(c[:m]).lower() if i % 5 == 0 \
            else jokm.decode_seq(c[:m])
        out += b"\n+\n" + bytes((np.asarray(q[:m]) + 33).astype(np.uint8))
        out += b"\n"
    return bytes(out)


@pytest.mark.parametrize("source", ["tiny", "ragged"])
def test_fastq_parse_and_extract_match(source):
    data = open(os.path.join(DATA, "tiny.fq"), "rb").read() \
        if source == "tiny" else _ragged_fastq()
    f1, f2 = jfq.parse_fastq_bytes(data), tfq.parse_fastq_bytes(data)
    for name in ("name_starts", "name_ends", "seq_starts", "seq_ends",
                 "qual_starts", "qual_ends", "buf"):
        assert np.array_equal(getattr(f1, name), getattr(f2, name)), name
    for a, b in zip(jfq.extract_padded_arrays(f1),
                    tfq.extract_padded_arrays(f2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(jfq.extract_padded_arrays(f1, 64),
                    tfq.extract_padded_arrays(f2, 64)):
        assert np.array_equal(a, b)
    assert np.array_equal(f1.seconds_mask(), f2.seconds_mask())
    if source == "ragged":
        assert f2.seconds_mask().sum() > 5
    with pytest.raises(ValueError):
        tfq.extract_padded_arrays(f2, 3)


def test_fastq_render_and_sinks(tmp_path):
    data = _ragged_fastq()
    f1, f2 = jfq.parse_fastq_bytes(data), tfq.parse_fastq_bytes(data)
    codes, quals, mask, _ = tfq.extract_padded_arrays(f2)
    new = ((quals.astype(np.int16) * 7 + 3) % 94).astype(np.int8)
    want = jfq.render_fastq_with_quals(f1, new, mask)
    got = tfq.render_fastq_with_quals(f2, new, mask)
    assert got == want and got != data
    assert tfq.render_fastq_with_quals(f2, quals, mask) == data
    plain, gz = tmp_path / "o.fq", tmp_path / "o.fq.gz"
    tfq.write_fastq_with_quals(f2, new, mask, str(plain))
    tfq.write_fastq_with_quals(f2, new, mask, gz)       # a PathLike
    assert plain.read_bytes() == want
    assert gzip.decompress(gz.read_bytes()) == want
    sink = tfq.open_fastq_sink(str(tmp_path / "s.fq.gz"))
    sink.write(want[:100])
    sink.write(want[100:])
    sink.close()
    assert tfq.read_fastq(str(tmp_path / "s.fq.gz")).buf.tobytes() == want
    with open(tmp_path / "w.fq", "wb") as f:
        tfq.write_fastq_with_quals(f2, new, mask, f)    # a writable
    assert (tmp_path / "w.fq").read_bytes() == want
    assert tfq.is_gz_path(b"x.gz") and not tfq.is_gz_path("x.fq")


def test_fastq_errors_and_empty():
    with pytest.raises(ValueError, match="multiple of 4"):
        tfq.parse_fastq_bytes(b"@a\nAC\n+\n")
    with pytest.raises(ValueError, match="'@'"):
        tfq.parse_fastq_bytes(b"a\nAC\n+\nII\n")
    with pytest.raises(ValueError, match="mismatch"):
        tfq.parse_fastq_bytes(b"@a\nAC\n+\nIII\n")
    fq = tfq.parse_fastq_bytes(b"")
    assert fq.num_reads == 0 and fq.max_len == 0
    codes, quals, mask, lens = tfq.extract_padded_arrays(fq)
    assert codes.shape == (0, 1) and fq.seconds_mask().shape == (0,)
    assert tfq.render_fastq_with_quals(fq, quals, mask) == b""
    one = tfq.parse_fastq_bytes(b"@a/2\nACGTN\n+\nIIII#")    # no last newline
    assert one.num_reads == 1 and one.seq_bytes(0) == b"ACGTN"
    assert one.qual_bytes(0) == b"IIII#" and one.name_bytes(0) == b"a/2"
    assert one.seconds_mask().tolist() == [True]


def test_synth_generators_give_the_same_reads():
    kw = dict(genome_len=900, read_len=40, coverage=5.0, error_rate=0.02,
              seed=9, num_rg=2, paired=True, n_rate=0.01)
    a, b = jsynth.make_dataset(**kw), tsynth.make_dataset(**kw)
    assert np.array_equal(a.genome, b.genome) and a.names == b.names
    for name in ("codes", "quals", "true_errors"):
        assert all(np.array_equal(x, y) for x, y in
                   zip(getattr(a, name), getattr(b, name)))
    assert a.rgs == b.rgs and a.seconds == b.seconds
    assert jsynth.to_fastq_bytes(a) == tsynth.to_fastq_bytes(b)
    kw = dict(genome_len=5000, read_len=50, num_reads=301, seed=4, num_rg=2)
    (ja, jerr), (ta, terr) = (jsynth.make_arrays_fast(**kw),
                              tsynth.make_arrays_fast(**kw))
    for name in ("codes", "quals", "mask", "rgs", "seconds"):
        assert np.array_equal(getattr(ja, name), getattr(ta, name)), name
    assert np.array_equal(jerr, terr)


def test_arrays_to_fastq_bytes_round_trip():
    arrays, _ = tsynth.make_arrays_fast(genome_len=3000, read_len=50,
                                        num_reads=1001, seed=3)
    data = tsynth.arrays_to_fastq_bytes(arrays)
    fq = tfq.parse_fastq_bytes(data)
    codes, quals, mask, lens = tfq.extract_padded_arrays(fq)
    assert np.array_equal(codes, arrays.codes) and mask.all()
    assert np.array_equal(quals, arrays.quals)
    assert np.array_equal(fq.seconds_mask(), arrays.seconds)
    assert fq.name_bytes(1000) == b"r000000500/1"
    assert np.array_equal(jfq.parse_fastq_bytes(data).seconds_mask(),
                          arrays.seconds)


def test_oracle_copies_agree():
    for alpha in (0.05, 7 / 50, 7 / 30, 1.0):
        assert jokm.alpha_threshold(alpha) == toracle.alpha_threshold(alpha)
        for k in (16, 32):
            assert np.array_equal(jolight.coverage_thresholds(alpha, k),
                                  toracle.coverage_thresholds(alpha, k))
    seq = b"ACGTNacgtnXY"
    assert np.array_equal(jokm.encode_seq(seq), toracle.encode_seq(seq))
    assert toracle.decode_seq(toracle.encode_seq(seq)) == b"ACGTNACGTNNN"

    class Cfg:
        sampled_bits_per_key = 20
        trusted_bits_per_key = 20
        num_hashes = 7
        min_log2_m = None

    for total, alpha, cov in [(0, 0.2, 30.0), (4000, 7 / 18, 18.0),
                              (182_466_627, 7 / 50, 50.0),
                              (10**10, 0.1, 30.0)]:
        assert jopipe.expected_bloom_keys(total, alpha, cov) == \
            toracle.expected_bloom_keys(total, alpha, cov)
        ja, jb = jopipe.bloom_params_for(Cfg, total, alpha, cov)
        ta, tb = toracle.bloom_params_for(Cfg, total, alpha, cov)
        assert (ja.log2_m, jb.log2_m, ja.num_hashes) == \
            (ta.log2_m, tb.log2_m, ta.num_hashes)
        assert ja.fpr(1000) == ta.fpr(1000)
    ta, tb = toracle.bloom_params_for(Cfg, 182_466_627, 7 / 50, 50.0)
    assert (ta.log2_m, tb.log2_m) == (28, 28)    # the full-size smoke run
    Cfg.min_log2_m = 30
    assert toracle.bloom_params_for(Cfg, 10, 0.2, 30.0)[0].log2_m == 30
    with pytest.raises(toracle.BloomCapacityError):
        toracle.BloomParams.for_keys(10**12, 20)
    with pytest.raises(jobloom.BloomCapacityError):
        jobloom.BloomParams.for_keys(10**12, 20)
    with pytest.raises(toracle.BloomCapacityError, match="resident"):
        toracle.check_layout_capacity(toracle.BloomParams(34), 33,
                                      "resident", "split")


def test_delta_math_gives_the_same_table():
    """Random covariate counts through both copies of the float64 delta
    math, carried across with state.convert."""
    rng = np.random.default_rng(12)
    num_rg, L = 2, 30
    total = rng.integers(0, 5000, (num_rg, 94, 2 * L))
    total[rng.random(total.shape) < 0.6] = 0
    errors = rng.binomial(total, 0.01)
    dtot = rng.integers(0, 9000, (num_rg, 94, 16))
    dtot[rng.random(dtot.shape) < 0.5] = 0
    derr = rng.binomial(dtot, 0.02)
    jt = JTables(num_rg, L, total.copy(), errors.copy(), dtot.copy(),
                 derr.copy())
    tt = convert.tables_from_numpy(total.astype(np.int32), errors, dtot, derr)
    assert (tt.num_rg, tt.max_len) == (num_rg, L)
    assert tt.cyc_total.dtype == np.int64
    assert np.array_equal(tt.q_total(), jt.q_total())
    want = jgatk.build_recal_table(jt)
    with toracle.captured_tables() as cap:
        got = toracle.build_recal_table(tt)
    assert cap["tables"] is tt
    assert got.dtype == np.int8 and np.array_equal(got, want)
    jd, td = jgatk.compute_deltas(jt), toracle.compute_deltas(tt)
    assert all(np.array_equal(jd[name], td[name]) for name in jd)
    dev = convert.recal_from_numpy(got)
    assert dev.dtype.is_floating_point is False and tuple(dev.shape) == \
        want.shape
    with pytest.raises(ValueError):
        convert.recal_from_numpy(got[0, 0])

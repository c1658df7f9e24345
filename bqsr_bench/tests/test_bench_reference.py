"""The plain reference against the program's CPU run on small samples:
every byte of the program's output is the reference's."""

import numpy as np
import pytest
import torch

from bqsr_bench.reference import recal
from bqsr_bench.tests.helpers import BAM, FASTQ, cpu_run


@pytest.mark.parametrize("name", [FASTQ, BAM])
def test_a_cpu_run_of_the_program_is_correct(name):
    res, out, err = cpu_run(name)
    assert res["correct"], err
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"] == {"qual_bytes_wrong": {"value": 0, "limit": 0},
                             "other_bytes_wrong": {"value": 0, "limit": 0}}


def test_reference_equals_the_programs_plain_pipeline():
    from kbbq_tpu_torch.io.batcher import ReadArrays
    from kbbq_tpu_torch.pipeline import RecalConfig, run_pipeline
    from bqsr_bench.harness import synth
    reads = synth.make_reads(4000, 150, 1200, 0.01, seed=21)
    n, L = reads["codes"].shape
    rgs = (np.arange(n) % 3).astype(np.int32)
    arrays = ReadArrays(reads["codes"], reads["quals"],
                        np.ones((n, L), bool), rgs, reads["seconds"])
    want = run_pipeline(arrays, RecalConfig(k=32, coverage=45.0),
                        device="cpu")
    got, counts = recal.recalibrate(reads["codes"], reads["quals"], rgs,
                                    reads["seconds"], 3, 32, 45.0, "cpu",
                                    chunk_rows=500)
    assert np.array_equal(got, want)
    assert counts["windows"] == n * (L - 31)
    assert 0 < counts["sampled"] < counts["trusted"] <= counts["windows"]
    assert counts["marks"] > 0
    assert sum(counts["rows_by_chunk"]) == n


def test_reference_filter_sizes_match_the_programs_sizing():
    from kbbq_tpu_torch.oracle import bloom_params_for
    from kbbq_tpu_torch.pipeline import RecalConfig
    total = 1_533_333 * 119
    alpha = recal.alpha_of(50.0)
    pa, pb = bloom_params_for(RecalConfig(k=32, coverage=50.0), total,
                              alpha, 50.0)
    assert recal.filter_sizes(total, alpha, 50.0, 20, 20) == \
        (pa.log2_m, pb.log2_m) == (28, 28)


def test_delta_math_equals_the_specifications():
    from kbbq_tpu_torch.oracle.covariate import CovariateTables
    from kbbq_tpu_torch.oracle.gatk import build_recal_table
    rng = np.random.default_rng(3)
    t = CovariateTables(2, 20)
    t.cyc_total[:, [12, 20, 37]] = rng.integers(0, 5000, (2, 3, 40))
    t.cyc_errors[:] = rng.binomial(t.cyc_total, 0.01)
    t.din_total[:, [12, 20, 37]] = rng.integers(0, 9000, (2, 3, 16))
    t.din_errors[:] = rng.binomial(t.din_total, 0.01)
    assert np.array_equal(
        recal.recal_table(t.cyc_total, t.cyc_errors, t.din_total,
                          t.din_errors), build_recal_table(t))


def test_reference_runs_on_any_device_it_is_given():
    codes = torch.tensor([[0, 1, 2, 3, 4, 0]], dtype=torch.int8)
    lanes, valid = recal.kmer_lanes(codes, 3)
    assert valid.tolist() == [[True, True, False, False]]


@pytest.mark.parametrize("a,b,same", [
    (b"", b"", True), (b"abc", b"abc", True), (b"abc", b"abd", False),
    (b"x" * 40 + b"y", b"x" * 40 + b"z", False),
    (b"x" * 41, b"x" * 40, False), (b"z" + b"x" * 40, b"y" + b"x" * 40,
                                    False)])
def test_same_bytes(a, b, same):
    from bqsr_bench.reference.outputs import same_bytes
    assert same_bytes(a, b, step=16) is same
    assert same_bytes(memoryview(a), b) is same

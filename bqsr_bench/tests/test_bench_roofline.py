"""The roofline arithmetic's counts: the copies agree with the program's
smoke script, and the least times follow from the counts."""

import pytest

from bqsr_bench.harness import roofline

COUNTS = {"reads": 1_533_333, "read_len": 150, "k": 32, "num_hashes": 7,
          "windows": 1_533_333 * 119, "log2_m_a": 28, "log2_m_b": 28,
          "sampled": 25_536_647, "trusted": 143_453_400,
          "rows_by_chunk": [65536], "marks_by_chunk": [55_106],
          "outside_by_chunk": [1_000_000]}


def test_operation_counts_are_the_specifications():
    assert roofline.hash_ops(32, 7) == 68
    assert roofline.hash_ops(32, 7, sample=True) == 80
    assert roofline.hash_ops(32, 7, sample=True, insert=True) == 81
    assert roofline.hash_ops(16, 7) == 64
    assert roofline.TRUST_RULE_OPS == 16


def test_counts_equal_the_smoke_scripts():
    smoke = pytest.importorskip("chip_smoke")
    for k, h in ((32, 7), (16, 3), (31, 7)):
        for s in (False, True):
            for i in (False, True):
                assert roofline.hash_ops(k, h, s, i) == \
                    smoke.hash_ops(k, h, s, i)
    assert roofline.TRUST_RULE_OPS == smoke.TRUST_RULE_OPS
    assert roofline.PEAK_BYTES_PER_S == smoke.PEAK_BYTES_PER_S


def test_least_times_of_the_passes():
    least = roofline.passes_least_s(COUNTS)
    nwin = COUNTS["windows"]
    filt = (1 << 28) // 8
    # pass 1 is bound by its operations, the probes and the build by bytes
    assert least["hash_build"] == pytest.approx(
        nwin * 81 / roofline.INT_OPS_PER_S)
    assert least["probe_trust"] == pytest.approx(
        (nwin * 9 + filt) / roofline.PEAK_BYTES_PER_S)
    assert least["build_b"] == pytest.approx(
        (nwin * 9 + 2 * filt) / roofline.PEAK_BYTES_PER_S)
    assert least["probe_b"] == pytest.approx(
        (nwin * 9 + filt) / roofline.PEAK_BYTES_PER_S)
    walk_bytes = 65536 * (150 + 119 + 150) + 55_106 * 12
    walk_ops = 1_000_000 * 12 + 55_106 * 270
    assert least["walk"] == pytest.approx(max(
        walk_bytes / roofline.PEAK_BYTES_PER_S,
        walk_ops / roofline.INT_OPS_PER_S))
    # the smoke script's bounds of the full-size sample (PERF.md), in ms
    assert least["hash_build"] * 1e3 == pytest.approx(0.8836, abs=1e-4)
    assert least["probe_trust"] * 1e3 == pytest.approx(0.5002, abs=1e-4)
    assert least["build_b"] * 1e3 == pytest.approx(0.5102, abs=1e-4)

"""kbbq_tpu_torch.gatk_report and the report options of the port's FASTQ
entry point against the JAX package on the CPU: the same covariate tables
(made with numpy from a seed) give byte-identical GATKReport files, each
package reads the other's, the Q' tables rebuilt from a report are equal,
and ``report_out`` then ``apply_report`` through ``recalibrate_fastq``
reproduce the plain run and the JAX package's output.
Tolerance: exact equality (bytes, and int8 tables).
"""

import io
import os

import numpy as np
import pytest
import torch

from kbbq_tpu import gatk_report as jreport
from kbbq_tpu.oracle import CovariateTables as JaxTables
from kbbq_tpu.pipeline import RecalConfig as JaxConfig
from kbbq_tpu.pipeline import recalibrate_fastq as jax_recalibrate_fastq

from kbbq_tpu_torch import gatk_report as treport
from kbbq_tpu_torch import kernels
from kbbq_tpu_torch.io.batcher import ReadArrays
from kbbq_tpu_torch.oracle import CovariateTables, build_recal_table
from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_fastq
from kbbq_tpu_torch.pipeline.recalibrate import apply_table_arrays

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TINY = os.path.join(DATA, "tiny.fq")
NUM_RG, MAX_LEN = 2, 40


def _counts(seed):
    """Covariate counts as a run could leave them: per (rg, q) a few
    thousand observations spread over cycles and dinucleotides, errors
    near the reported rate, most quality rows empty."""
    rng = np.random.default_rng(seed)
    cyc_total = np.zeros((NUM_RG, 94, 2 * MAX_LEN), np.int64)
    din_total = np.zeros((NUM_RG, 94, 16), np.int64)
    cyc_errors, din_errors = np.zeros_like(cyc_total), np.zeros_like(din_total)
    for rg in range(NUM_RG):
        for q in rng.choice(np.arange(6, 42), size=9, replace=False):
            cyc_total[rg, q] = rng.integers(0, 400, 2 * MAX_LEN)
            cyc_total[rg, q, rng.random(2 * MAX_LEN) < 0.2] = 0
            p = 10 ** (-(q + rng.normal(0, 3)) / 10)
            cyc_errors[rg, q] = rng.binomial(cyc_total[rg, q], min(p, 1.0))
            # the dinucleotide table counts the same bases but the first
            tot = int(cyc_total[rg, q].sum() * 0.97)
            din_total[rg, q] = rng.multinomial(tot, np.full(16, 1 / 16))
            din_errors[rg, q] = rng.binomial(din_total[rg, q], min(p, 1.0))
    return cyc_total, cyc_errors, din_total, din_errors


def _both_tables(seed):
    parts = _counts(seed)
    return (JaxTables(NUM_RG, MAX_LEN, *(a.copy() for a in parts)),
            CovariateTables(NUM_RG, MAX_LEN, *(a.copy() for a in parts)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("names", [["rgA", "rgB"], ["", "a b\tc%"]])
def test_both_packages_write_the_same_bytes(seed, names, tmp_path):
    jt, tt = _both_tables(seed)
    a, b = io.StringIO(), io.StringIO()
    jreport.write_gatk_report(jt, names, a)
    treport.write_gatk_report(tt, names, b)
    assert a.getvalue() == b.getvalue()
    assert a.getvalue().startswith("#:GATKReport.v1.1:3\n")
    assert a.getvalue().count("\n") > 200          # the tables have rows
    # to a path as well
    treport.write_gatk_report(tt, names, str(tmp_path / "t.report"))
    assert (tmp_path / "t.report").read_text() == a.getvalue()


@pytest.mark.parametrize("seed", [3, 4])
def test_each_reads_the_others_report_and_rebuilds_the_same_table(
        seed, tmp_path):
    jt, tt = _both_tables(seed)
    names = ["in1.fq", "dir with space/in2.fq"]
    jpath, tpath = str(tmp_path / "j.report"), str(tmp_path / "t.report")
    jreport.write_gatk_report(jt, names, jpath)
    treport.write_gatk_report(tt, names, tpath)
    parsed = [jreport.read_gatk_report(jpath), jreport.read_gatk_report(tpath),
              treport.read_gatk_report(jpath), treport.read_gatk_report(tpath)]
    assert all(p == parsed[0] for p in parsed)
    assert set(parsed[0]) == {"RecalTable0", "RecalTable1", "RecalTable2"}
    want = jreport.recal_table_from_report(parsed[0], names, MAX_LEN)
    got = treport.recal_table_from_report(parsed[3], names, MAX_LEN)
    assert got.dtype == np.int8 and got.shape == (NUM_RG, 94, 2 * MAX_LEN, 17)
    assert np.array_equal(got, want)
    # a read group the report does not know keeps its reported qualities
    other = treport.recal_table_from_report(parsed[3], ["x", names[1]],
                                            MAX_LEN)
    assert np.array_equal(other[1], want[1])
    assert np.array_equal(other[0, 10, 0], np.full(17, 10, np.int8))
    # observed cells equal the table built directly from the counts
    direct = build_recal_table(tt)
    rg, q, c = np.nonzero(tt.cyc_total > 0)
    assert np.array_equal(got[rg, q, c, 16], direct[rg, q, c, 16])


def test_rg_label_equal_and_injective():
    names = ["rg 1", "rg_1", "rg%201", "rg\t1", "", "a b", "a%20b",
             "a\nb", "plain", "x\r\x0b\x0cy"]
    labels = [treport._rg_label(n) for n in names]
    assert labels == [jreport._rg_label(n) for n in names]
    assert len(set(labels)) == len(labels)
    assert not any(c.isspace() for lab in labels for c in lab)


def test_report_out_then_apply_report_through_the_entry_point(tmp_path):
    """On tests/data/tiny.fq: the run that writes a report, the run that
    applies it and the plain run give the same bytes, which are the JAX
    package's; the two packages' report files are equal; the apply run
    launches no kernel."""
    kw = dict(k=16, coverage=18.0, batch_size=64)
    plain, direct, applied = (str(tmp_path / n) for n in
                              ("plain.fq", "direct.fq", "applied.fq"))
    treport_path, jreport_path = (str(tmp_path / n) for n in
                                  ("t.report", "j.report"))
    recalibrate_fastq(TINY, plain, RecalConfig(**kw), device="cpu")
    info = recalibrate_fastq(TINY, direct, RecalConfig(**kw), device="cpu",
                             report_out=treport_path)
    before = dict(kernels.LAUNCHES)
    info2 = recalibrate_fastq(TINY, applied, RecalConfig(**kw), device="cpu",
                              apply_report=treport_path)
    assert kernels.LAUNCHES == before
    assert info == info2 and info["num_reads"] == 216
    want = open(os.path.join(DATA, "tiny.recal.golden.fq"), "rb").read()
    for path in (plain, direct, applied):
        assert open(path, "rb").read() == want

    jdirect, japplied = str(tmp_path / "jd.fq"), str(tmp_path / "ja.fq")
    jax_recalibrate_fastq(TINY, jdirect, JaxConfig(**kw),
                          report_out=jreport_path)
    assert open(jreport_path).read() == open(treport_path).read()
    # each package applies the other's report
    jax_recalibrate_fastq(TINY, japplied, JaxConfig(**kw),
                          apply_report=treport_path)
    recalibrate_fastq(TINY, applied, RecalConfig(**kw), device="cpu",
                      apply_report=jreport_path)
    for path in (jdirect, japplied, applied):
        assert open(path, "rb").read() == want


@pytest.mark.parametrize("chunk_rows", [None, 1, 5])
def test_apply_table_arrays_is_pass_4_alone(chunk_rows):
    """The gather of apply_table_arrays against the JAX package's, on
    ragged reads with Ns and low qualities, whatever the chunk size."""
    from kbbq_tpu.io.batcher import ReadArrays as JaxArrays
    from kbbq_tpu.pipeline.recalibrate import \
        apply_table_arrays as jax_apply_table_arrays
    rng = np.random.default_rng(9)
    N, L = 23, MAX_LEN
    codes = rng.integers(0, 5, (N, L)).astype(np.int8)
    quals = rng.integers(2, 42, (N, L)).astype(np.int8)
    lens = rng.integers(1, L + 1, N)
    mask = np.arange(L)[None, :] < lens[:, None]
    rgs = rng.integers(0, NUM_RG, N).astype(np.int32)
    seconds = rng.random(N) < 0.5
    table = rng.integers(1, 60, (NUM_RG, 94, 2 * L, 17)).astype(np.int8)
    want = jax_apply_table_arrays(
        JaxArrays(np.where(mask, codes, 4).astype(np.int8), quals, mask, rgs,
                  seconds), table, 8)
    got = apply_table_arrays(ReadArrays(codes, quals, mask, rgs, seconds),
                             table, device="cpu", chunk_rows=chunk_rows)
    assert got.dtype == np.int8 and got.shape == (N, L)
    assert np.array_equal(got[mask], np.asarray(want)[mask])
    empty = ReadArrays(codes[:0], quals[:0], mask[:0], rgs[:0], seconds[:0])
    assert apply_table_arrays(empty, table, device="cpu").shape == (0, L)


def test_report_options_default_to_the_card(tmp_path, monkeypatch):
    """apply_report too means CUDA unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.fq"
    with pytest.raises(RuntimeError, match="CUDA"):
        recalibrate_fastq(TINY, str(out), RecalConfig(k=16),
                          apply_report=str(tmp_path / "none.report"))
    with pytest.raises(RuntimeError, match="CUDA"):
        apply_table_arrays(
            ReadArrays(np.zeros((1, 4), np.int8), np.zeros((1, 4), np.int8),
                       np.ones((1, 4), bool), np.zeros(1, np.int32),
                       np.zeros(1, bool)),
            np.zeros((1, 94, 8, 17), np.int8))
    assert not out.exists()

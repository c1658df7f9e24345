"""More than one device in the port (kbbq_tpu_torch/parallel/): the
replicated-filter layout over torch.distributed (and, on the routed cases,
the hash-space-sharded one), on the CPU over gloo at 1, 2 and 4 ranks (real processes and real collectives; on cards the same code
runs over NCCL).  Every route that takes ``devices`` must write the bytes of
one device and of the JAX package (its ``recalibrate_arrays`` and its
``run_pipeline(devices=8)`` on the 8-device CPU mesh of conftest.py).  Every
launch starts its ranks anew (each imports torch, seconds per launch), so
each test groups its checks into few launches.  Tolerance: exact equality.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from kbbq_tpu.io.batcher import ReadArrays as JReadArrays
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline import recalibrate_arrays as j_recalibrate_arrays
from kbbq_tpu.pipeline.recalibrate import run_pipeline as j_run_pipeline
from kbbq_tpu.pipeline.streaming import (
    recalibrate_fastq_streaming as j_streaming)
from kbbq_tpu.utils.synth import make_dataset

from kbbq_tpu_torch import kernels
from kbbq_tpu_torch.io.batcher import ReadArrays
from kbbq_tpu_torch.parallel import (launch, mesh, or_merge,
                                     recalibrate_arrays_resident_sharded,
                                     sharded, sharded_recalibrate_arrays)
from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_bam,
                                     recalibrate_bam_streaming,
                                     recalibrate_cram,
                                     recalibrate_fastq_streaming,
                                     run_pipeline)
from kbbq_tpu_torch.pipeline.stream_resident import \
    recalibrate_arrays_windowed
from kbbq_tpu_torch.utils.synth import (arrays_to_bam_bytes,
                                        arrays_to_cram_bytes,
                                        make_arrays_fast, read_starts)

import _rank_cases
from test_torch_stream import _records

CFG = dict(k=16, coverage=20.0, batch_size=64)


@pytest.fixture(scope="module")
def arrays():
    """tests/test_parallel.py's dataset: 2 read groups, pairs, Ns."""
    ds = make_dataset(genome_len=800, read_len=50, coverage=20.0,
                      error_rate=0.02, seed=31, num_rg=2, paired=True,
                      n_rate=0.01)
    return ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)


@pytest.fixture(scope="module")
def want(arrays):
    """The one-device bytes: the JAX package's single chip and its 8-device
    replicated mesh, and the port's one device, all equal."""
    ja = JReadArrays(arrays.codes, arrays.quals, arrays.mask, arrays.rgs,
                     arrays.seconds)
    one = j_recalibrate_arrays(ja, JRecalConfig(**CFG))
    eight = j_run_pipeline(ja, JRecalConfig(**CFG), devices=8,
                           bloom_layout="replicated")
    port = run_pipeline(arrays, RecalConfig(**CFG), device="cpu")
    assert (one == eight).all() and (one == port).all()
    return port


def _no_group():
    import torch.distributed as dist
    return not dist.is_initialized() and not torch.cuda.is_initialized()


# ------------------------------------------------------------- the group

def test_merges_equal_numpy_at_four_ranks():
    """or_merge against numpy's OR, for word counts not divisible by D and
    below D; sum_merge against numpy's sum; broadcast_table; the ranks'
    kernel counts summed into the caller's; no group left behind."""
    rng = np.random.default_rng(8)
    D = 4
    words = [rng.integers(-2**31, 2**31, size=(D, w), dtype=np.int64)
             .astype(np.int32) for w in (1024, 5, 3, 1)]
    cov = {"cyc_total": rng.integers(0, 1 << 40, (D, 2, 3, 8)),
           "cyc_errors": rng.integers(0, 9, (D, 2, 3, 8)),
           "din_total": rng.integers(0, 1 << 40, (D, 2, 3, 16)),
           "din_errors": rng.integers(0, 9, (D, 2, 3, 16))}
    recal = rng.integers(-128, 128, (2, 94, 8, 17), dtype=np.int64) \
        .astype(np.int8)
    kernels.reset_launches()
    t: dict = {}
    res = launch(_rank_cases.merges, D, "cpu", words, cov, recal, timings=t)
    assert [r["rank"] for r in res] == list(range(D))
    for r in res:
        assert r["world"] == D and r["backend"] == "gloo"
        for got, w in zip(r["or"], words):
            assert got.dtype == np.int32
            assert (got == np.bitwise_or.reduce(w, axis=0)).all()
        for n, a in cov.items():
            assert (r["cov"][n] == a.sum(axis=0)).all()
        assert (r["table"] == recal).all()
    assert kernels.ENTRY_LAUNCHES == {e: D for e in kernels.ENTRY_KERNEL}
    assert kernels.LAUNCHES == {"bloom_probe": 4 * D,
                                "bloom_or_words": 4 * D, "walk_errors": D,
                                "walk_round": 3 * D}
    assert t["world"] == D and t["backend"] == "gloo" and t["spawn"] > 0
    assert len(t["launches_by_rank"]) == D and t["merge_bytes"] > 0
    assert _no_group()
    kernels.reset_launches()


def test_a_failing_rank_fails_the_call():
    with pytest.raises(ValueError, match="rank 1 failed on purpose"):
        launch(_rank_cases.fail_on_rank, 2, "cpu", 1)
    assert _no_group()


def test_the_groups_store_is_bound_before_any_rank_starts(monkeypatch):
    """The group's store listens in the caller before a rank starts.  A
    port chosen first and bound later by rank 0 can be taken by another
    process in between (it was, once in 8 launches on a 4-card machine):
    here it is taken before the ranks start, and the call must not mind."""
    import socket
    with socket.socket() as busy:
        busy.bind(("localhost", 0))
        busy.listen()
        port = busy.getsockname()[1]
        monkeypatch.setattr(mesh, "_free_port", lambda: port, raising=False)
        out = launch(_rank_cases.fail_on_rank, 2, "cpu", -1)
    assert [int(x) for x in out] == [0, 1]
    assert _no_group()


def test_reference_refusals(arrays, want, monkeypatch):
    """The JAX package's messages: more devices than there are and a batch
    the devices do not divide, before any rank starts.  The hash-space-
    sharded layout, asked for or picked by auto over the replicated
    layout's budget, runs and writes one device's bytes."""
    cfg = RecalConfig(**CFG)
    with pytest.raises(ValueError, match=r"--devices 100000 requested but "
                                         r"only \d+ device\(s\) available"):
        run_pipeline(arrays, cfg, device="cpu", devices=100000)
    with pytest.raises(ValueError, match="must be divisible by --devices 3"):
        run_pipeline(arrays, cfg, device="cpu", devices=3)
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        recalibrate_arrays_resident_sharded(arrays, cfg, 3, device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        sharded_recalibrate_arrays(arrays, cfg, 3, device="cpu")
    got = run_pipeline(arrays, cfg, device="cpu", devices=2,
                       bloom_layout="sharded")
    assert (got == want).all()
    with pytest.raises(ValueError, match="unknown bloom layout"):
        run_pipeline(arrays, cfg, device="cpu", devices=2,
                     bloom_layout="diagonal")
    monkeypatch.setattr(sharded, "REPLICATED_BLOOM_BUDGET", 1 << 10)
    t: dict = {}
    got = run_pipeline(arrays, cfg, device="cpu", devices=2, timings=t)
    assert (got == want).all()
    assert t["shard_words_a"] > 0         # auto over the budget: sharded
    # one device reads no layout, as in the reference
    assert run_pipeline(arrays, cfg, device="cpu", devices=1,
                        bloom_layout="sharded").shape == arrays.codes.shape
    with pytest.raises(RuntimeError, match="CUDA"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        run_pipeline(arrays, cfg, devices=2)
    assert _no_group()


# ----------------------------------------------------------- in memory

@pytest.mark.parametrize("devices", [2, 4])
def test_run_pipeline_on_ranks_writes_one_devices_bytes(arrays, want,
                                                        devices):
    """The resident path on each rank's rows (no checkpoint): the bytes of
    one device and of the JAX package; timings name the slowest rank's
    stages and the group's figures."""
    t: dict = {}
    got = run_pipeline(arrays, RecalConfig(**CFG), device="cpu",
                       devices=devices, timings=t)
    assert got.shape == want.shape and (got == want).all()
    for stage in ("setup", "h2d", "pass1", "pass2", "pass3", "deltas",
                  "pass4", "spawn", "merge"):
        assert t[stage] >= 0, stage
    assert t["world"] == devices and t["backend"] == "gloo"
    # filters A and B through or_merge, the tables through sum_merge and
    # the table broadcast: bytes sent by the busiest rank
    assert t["merge_bytes"] > 0
    assert _no_group()


def test_resident_sharded_at_one_rank(arrays, want):
    got = recalibrate_arrays_resident_sharded(arrays, RecalConfig(**CFG), 1,
                                              device="cpu")
    assert (got == want).all()


def test_windowed_ranks_checkpoint_and_resume_on_other_counts(arrays, want,
                                                              tmp_path):
    """The windowed engine on 4 ranks (windows of 50 reads, every 4th to a
    rank) writes the one-device bytes and, through rank 0, the one-device
    checkpoint files; a resume after pass 2 on 2 ranks, on one device and
    by the JAX package gives the same bytes again."""
    cfg = RecalConfig(**CFG)
    ck1, ck4 = tmp_path / "one", tmp_path / "four"
    one = recalibrate_arrays_windowed(arrays, cfg, checkpoint_dir=str(ck1),
                                      device="cpu")
    assert (one == want).all()
    got = sharded_recalibrate_arrays(arrays, cfg, 4, checkpoint_dir=str(ck4),
                                     device="cpu", window_rows=50)
    assert (got == want).all()
    for name in ("rows_a", "rows_b", "cov_cyc_total", "cov_cyc_errors",
                 "cov_din_total", "cov_din_errors"):
        assert (np.load(ck1 / f"{name}.npy") ==
                np.load(ck4 / f"{name}.npy")).all(), name
    meta = json.loads((ck4 / "meta.json").read_text())
    assert meta == json.loads((ck1 / "meta.json").read_text())
    # drop pass 3: every resume loads filters A and B and reruns it
    meta["passes_done"] = ["rows_a", "rows_b"]
    (ck4 / "meta.json").write_text(json.dumps(meta))
    ckj = tmp_path / "jax"
    shutil.copytree(ck4, ckj)
    shutil.copytree(ck4, tmp_path / "port1")
    got2 = sharded_recalibrate_arrays(arrays, cfg, 2, checkpoint_dir=str(ck4),
                                      device="cpu", window_rows=64)
    assert (got2 == want).all()
    got1 = recalibrate_arrays_windowed(
        arrays, cfg, checkpoint_dir=str(tmp_path / "port1"), device="cpu")
    assert (got1 == want).all()
    ja = JReadArrays(arrays.codes, arrays.quals, arrays.mask, arrays.rgs,
                     arrays.seconds)
    gotj = j_recalibrate_arrays(ja, JRecalConfig(**CFG),
                                checkpoint_dir=str(ckj))
    assert (gotj == want).all()
    # a checkpoint of other parameters is refused before any rank starts
    with pytest.raises(ValueError, match="different parameters"):
        sharded_recalibrate_arrays(arrays, RecalConfig(**{**CFG, "k": 17}),
                                   2, checkpoint_dir=str(ck4), device="cpu")
    assert _no_group()


# ------------------------------------------------------------- streamed

@pytest.fixture(scope="module")
def fq_files(tmp_path_factory):
    """tests/test_stream.py's two inputs (a plain and a gzip FASTQ)."""
    import gzip
    from kbbq_tpu.utils.synth import to_fastq_bytes
    d = tmp_path_factory.mktemp("par_stream")
    ds1 = make_dataset(genome_len=900, read_len=55, coverage=22.0,
                       error_rate=0.02, seed=41, paired=True, n_rate=0.01)
    ds2 = make_dataset(genome_len=700, read_len=48, coverage=18.0,
                       error_rate=0.02, seed=42)
    a, b = d / "a.fq", d / "b.fq.gz"
    a.write_bytes(_records(to_fastq_bytes(ds1), 359))
    b.write_bytes(gzip.compress(to_fastq_bytes(ds2)))
    return d, [str(a), str(b)]


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_streamed_fastq_on_two_ranks(fq_files, layout):
    """devices=2 against devices=1 and the JAX package's devices=8 (with
    the sharded layout: its devices=2 sharded run), into a writable sink
    (relayed through rank 0's file), with a checkpoint and a report: the
    same bytes, the same report, the one-device checkpoint (the sharded
    filters gathered to rank 0), which resumes after pass 2 at one rank
    with the same bytes; the sharded walk's lane groups took at most three
    collectives each."""
    d, paths = fq_files
    d = d / layout
    d.mkdir()
    cfg = dict(k=16, coverage=22.0, batch_size=64)
    j8 = d / "j8.fq"
    j_streaming(paths, str(j8), JRecalConfig(**cfg), chunk_reads=200,
                devices=8 if layout == "replicated" else 2,
                bloom_layout=layout)
    one = d / "one.fq"
    info1 = recalibrate_fastq_streaming(paths, str(one), RecalConfig(**cfg),
                                        chunk_reads=200, device="cpu",
                                        checkpoint_dir=str(d / "ck1"),
                                        report_out=str(d / "one.report"))
    sink = io.BytesIO()
    t: dict = {}
    info = recalibrate_fastq_streaming(
        paths, sink, RecalConfig(**cfg), chunk_reads=200, device="cpu",
        devices=2, checkpoint_dir=str(d / "ck2"),
        report_out=str(d / "two.report"), timings=t, bloom_layout=layout)
    assert sink.getvalue() == one.read_bytes() == j8.read_bytes()
    assert (d / "two.report").read_bytes() == \
        (d / "one.report").read_bytes()
    assert info == info1 and info["chunks"] == 4
    for name in ("rows_a", "rows_b", "cov_cyc_total"):
        assert (np.load(d / "ck1" / f"{name}.npy") ==
                np.load(d / "ck2" / f"{name}.npy")).all()
    assert t["world"] == 2 and t["scan"] >= 0 and t["pass4"] >= 0
    assert (t["exchange_bytes"] > 0) == (layout == "sharded")
    # the sharded walk: a walk a window step, lane groups of three
    # collectives at most (the agreement, the pairs, the answers)
    assert (t["walk_groups"] > 0) == (layout == "sharded")
    assert t["walk_rounds"] <= t["walk_groups"] <= t["walk_collectives"] \
        <= 3 * t["walk_groups"]
    if layout == "sharded":
        meta = json.loads((d / "ck2" / "meta.json").read_text())
        meta["passes_done"] = ["rows_a", "rows_b"]
        meta.pop("pass4", None)
        (d / "ck2" / "meta.json").write_text(json.dumps(meta))
        again = d / "again.fq"
        recalibrate_fastq_streaming(paths, str(again), RecalConfig(**cfg),
                                    chunk_reads=200, device="cpu",
                                    checkpoint_dir=str(d / "ck2"))
        assert again.read_bytes() == one.read_bytes()
    assert _no_group()


@pytest.fixture(scope="module")
def aln(tmp_path_factory):
    """One set of alignments as BAM and as CRAM (3 read groups, reverse
    strands, secondary and supplementary copies)."""
    d = tmp_path_factory.mktemp("par_aln")
    a, _ = make_arrays_fast(genome_len=4000, read_len=41, num_reads=600,
                            seed=1)
    starts = read_starts(4000, 41, 600, 1)
    (d / "in.bam").write_bytes(arrays_to_bam_bytes(a, starts,
                                                   extra_share=0.1)[0])
    (d / "in.cram").write_bytes(arrays_to_cram_bytes(
        a, starts, extra_share=0.1, records_per_container=128)[0])
    return d


@pytest.fixture(scope="module")
def bam_one(aln):
    """The one-device outputs of the alignment routes: windowed and
    whole-file BAM (set_oq) and CRAM (under a pinned clock)."""
    import time
    cfg = RecalConfig(k=16, coverage=18.0, batch_size=64)
    recalibrate_bam_streaming(str(aln / "in.bam"), str(aln / "s1.bam"), cfg,
                              set_oq=True, chunk_records=100, device="cpu")
    recalibrate_bam(str(aln / "in.bam"), str(aln / "w1.bam"), cfg,
                    set_oq=True, device="cpu")
    clock = time.time
    time.time = lambda: 1.7e9
    try:
        recalibrate_cram(str(aln / "in.cram"), str(aln / "c1.cram"), cfg,
                         device="cpu")
    finally:
        time.time = clock
    return aln


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_windowed_bam_on_two_ranks(bam_one, layout):
    aln = bam_one
    cfg = RecalConfig(k=16, coverage=18.0, batch_size=64)
    info = recalibrate_bam_streaming(str(aln / "in.bam"),
                                     str(aln / "s2.bam"), cfg, set_oq=True,
                                     chunk_records=100, device="cpu",
                                     devices=2, bloom_layout=layout)
    assert (aln / "s2.bam").read_bytes() == (aln / "s1.bam").read_bytes()
    assert info["windows"] >= 6
    assert _no_group()


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_whole_file_bam_on_two_ranks(bam_one, layout):
    aln = bam_one
    cfg = RecalConfig(k=16, coverage=18.0, batch_size=64)
    recalibrate_bam(str(aln / "in.bam"), str(aln / "w2.bam"), cfg,
                    set_oq=True, device="cpu", devices=2,
                    bloom_layout=layout)
    assert (aln / "w2.bam").read_bytes() == (aln / "w1.bam").read_bytes()
    assert _no_group()


@pytest.mark.parametrize("layout", ["auto", "sharded"])
def test_cram_on_two_ranks(bam_one, monkeypatch, layout):
    """CRAM gzip blocks stamp the clock: both writes under one pinned
    clock."""
    import time
    aln = bam_one
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    cfg = RecalConfig(k=16, coverage=18.0, batch_size=64)
    recalibrate_cram(str(aln / "in.cram"), str(aln / "c2.cram"), cfg,
                     device="cpu", devices=2, bloom_layout=layout)
    assert (aln / "c2.cram").read_bytes() == (aln / "c1.cram").read_bytes()
    assert _no_group()


def test_or_merge_is_the_one_code_path():
    """No bitwise reduction of the backend: NCCL has none (ReduceOp.BOR is
    gloo's), so the CPU runs the exchange the card runs."""
    import inspect
    src = inspect.getsource(or_merge)
    assert "all_to_all_single" in src and "BOR" not in src
    assert mesh.BACKENDS == {"cuda": "nccl", "cpu": "gloo"}

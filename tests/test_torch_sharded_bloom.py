"""The hash-space-sharded Bloom layout of the port
(kbbq_tpu_torch/parallel/sharded_bloom.py) on the CPU, at 2 and 4 ranks over
gloo (real processes, real collectives; on cards the same code runs over
NCCL), against the JAX package's ``run_pipeline(..., devices=D,
bloom_layout="sharded")`` on the 8-device CPU mesh of conftest.py and
against one device.  No rank holds more than m/32/D words of a filter; the
D shards laid end to end are the one-device filter word for word; a device
count that is not a power of two is refused before any rank starts, where
the reference fails in JAX's placement.  The plain walk with its membership
test passed in (the counterpart of JAX's ``query_fn``) equals
``infer_errors_plain``.  Every launch starts its ranks anew, so the tests
share fixtures and launches.  Tolerance: exact equality.
"""

import json
import time

import numpy as np
import pytest
import torch

from kbbq_tpu.io.batcher import ReadArrays as JReadArrays
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline.recalibrate import run_pipeline as j_run_pipeline
from kbbq_tpu.utils.synth import make_dataset

from kbbq_tpu_torch.io.batcher import ReadArrays
from kbbq_tpu_torch.ops import bloom as tb
from kbbq_tpu_torch.ops.hash_cache import hash_cache_build, hash_cache_chunk
from kbbq_tpu_torch.ops.inference import (LocalExchange, infer_errors_plain,
                                          infer_errors_sharded, walk_plain)
from kbbq_tpu_torch.ops.bloom import _query_rows_w
from kbbq_tpu_torch.parallel import launch, sharded
from kbbq_tpu_torch.parallel.resident_sharded import plan_for
from kbbq_tpu_torch.parallel.sharded_bloom import sharded_params
from kbbq_tpu_torch.pipeline import RecalConfig, run_pipeline

import _rank_cases

CFG = dict(k=16, coverage=20.0, batch_size=64)
SAMPLE = 0x60000000         # inclusive keep threshold of the filter's sample


def _jax(arrays):
    return JReadArrays(arrays.codes, arrays.quals, arrays.mask, arrays.rgs,
                       arrays.seconds)


def _no_group():
    import torch.distributed as dist
    return not dist.is_initialized() and not torch.cuda.is_initialized()


@pytest.fixture(scope="module")
def arrays():
    """tests/test_parallel.py's dataset: 2 read groups, pairs, Ns."""
    ds = make_dataset(genome_len=800, read_len=50, coverage=20.0,
                      error_rate=0.02, seed=31, num_rg=2, paired=True,
                      n_rate=0.01)
    return ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)


@pytest.fixture(scope="module")
def one(arrays):
    return run_pipeline(arrays, RecalConfig(**CFG), device="cpu")


@pytest.mark.parametrize("devices", [2, 4])
def test_sharded_layout_writes_the_references_bytes(arrays, one, devices):
    """run_pipeline's multi-device route with bloom_layout="sharded" (the
    resident path on each rank's rows): the JAX package's sharded bytes at
    the same D and one device's; each rank held m/32/D words of each
    filter and exchanged pairs with the others."""
    t: dict = {}
    got = run_pipeline(arrays, RecalConfig(**CFG), device="cpu",
                       devices=devices, bloom_layout="sharded", timings=t)
    ref = j_run_pipeline(_jax(arrays), JRecalConfig(**CFG), devices=devices,
                         bloom_layout="sharded")
    assert got.shape == one.shape
    assert (got == ref).all() and (got == one).all()
    plan = plan_for(arrays, RecalConfig(**CFG), "sharded", devices)
    assert t["shard_words_a"] == (1 << (plan.log2_ma - 5)) // devices
    assert t["shard_words_b"] == (1 << (plan.log2_mb - 5)) // devices
    assert t["exchange_bytes"] > 0 and t["exchange"] >= 0
    assert t["world"] == devices and t["backend"] == "gloo"
    assert _no_group()


def test_bump_on_a_tiny_input_follows_the_reference(arrays, monkeypatch):
    """With the filters' floor lowered in both packages, a small input's
    filters fall under 2^(5 + D.bit_length() + 5) bits and the layout
    raises them (ShardedBloomRecalPipeline's bump): the output is the JAX
    package's sharded output at the same D, which one device's need not
    be."""
    import kbbq_tpu.oracle.bloom as jbloom
    import kbbq_tpu_torch.oracle.bloom as tbloom
    monkeypatch.setattr(jbloom, "MIN_BLOOM_LOG2", 5)
    monkeypatch.setattr(tbloom, "MIN_BLOOM_LOG2", 5)
    cfg = RecalConfig(**CFG)
    small = ReadArrays(*(a[:48] for a in (arrays.codes, arrays.quals,
                                          arrays.mask, arrays.rgs,
                                          arrays.seconds)))
    one_plan = plan_for(small, cfg)
    plan = plan_for(small, cfg, "sharded", 4)
    assert plan.log2_ma == plan.log2_mb == 13
    assert one_plan.log2_ma < 13 and one_plan.log2_mb < 13
    got = run_pipeline(small, cfg, device="cpu", devices=4,
                       bloom_layout="sharded")
    ref = j_run_pipeline(_jax(small), JRecalConfig(**CFG), devices=4,
                         bloom_layout="sharded")
    assert (got == ref).all()
    assert _no_group()


@pytest.fixture(scope="module")
def hashed(arrays):
    """The one-device hash cache of every window and the filter built from
    a sample of about 3/8 of the valid windows (many windows untrusted:
    the walks have work)."""
    codes = torch.from_numpy(arrays.codes)
    h1, word, keep, filt = hash_cache_build(codes, 0, 16, 7, SAMPLE, 16)
    return codes, h1, word, filt


@pytest.mark.parametrize("walk_rows, chunk", [(1 << 21, 1000), (5, 60)],
                         ids=["one_block", "blocks_of_5"])
def test_shards_end_to_end_are_the_one_device_filter(arrays, hashed,
                                                     walk_rows, chunk):
    """Four ranks with unequal rows, one with none, build one sharded
    filter, exchanging in chunks of `chunk` pairs: each holds m/32/4 words,
    the shards gathered on rank 0 are the one-device filter word for word,
    the collective word test answers as the whole filter does, and the walk
    through it (blocks of `walk_rows` reads, lane groups of chunk // 48
    lanes) marks what infer_errors_plain marks against the whole filter.
    Every rank takes part in every lane group: three collectives a group,
    one for the last agreement of a block."""
    codes, h1, word, filt = hashed
    N = codes.shape[0]
    splits = [0, N // 3, N // 2, N // 2, N]
    res = launch(_rank_cases.sharded_filter, 4, "cpu", arrays.codes, splits,
                 16, 7, SAMPLE, 16, chunk, walk_rows)
    assert [r["words"] for r in res] == [filt.numel() // 4] * 4
    whole = res[0]["whole"].view(np.int32)
    assert whole.shape == (filt.numel(),)
    assert (whole == filt.numpy()).all()
    assert all(r["whole"] is None for r in res[1:])
    for r, s, e in zip(res, splits, splits[1:]):
        want = tb.bloom_query_words_plain(filt, h1[s:e], word[s:e])
        assert (r["hits"] == want.numpy()).all()
        err = infer_errors_plain(filt, codes[s:e], 16, 7, trusted0=want)
        assert (r["err"] == err.numpy()).all()
        assert r["err"].any() or s == e
    assert res[2]["hits"].shape == (0, h1.shape[1])
    assert all(r["exchange_bytes"] > 0 for r in res)
    blocks = -(-(N - N // 2) // walk_rows)        # the busiest rank's
    stats = [r["stats"] for r in res]
    groups = stats[0]["walk_groups"]
    assert all(st["walk_groups"] == groups for st in stats)
    assert all(st["walk_collectives"] == 3 * groups - 2 * blocks
               for st in stats)
    assert stats[2]["walk_rounds"] == 0 < min(stats[r]["walk_rounds"]
                                              for r in (0, 1, 3))
    if chunk < 100:                  # lane groups of one lane
        assert groups > sum(st["walk_rounds"] for st in stats)
    assert _no_group()


def test_the_walks_group_loop_raises_no_deprecation_warning(arrays, hashed):
    """Two gloo ranks walk through a sharded filter in lane groups of one
    lane (many exchanges) with torch's deprecation warnings raised as errors
    in the ranks: no exchange calls a deprecated collective
    (``all_gather_into_tensor``), and the marks are the whole filter's."""
    codes, h1, word, filt = hashed
    N = codes.shape[0]
    res = launch(_rank_cases.warnings_as_errors, 2, "cpu",
                 _rank_cases.sharded_filter, arrays.codes, [0, N // 3, N],
                 16, 7, SAMPLE, 16, 60)
    for r, s, e in zip(res, (0, N // 3), (N // 3, N)):
        want = tb.bloom_query_words_plain(filt, h1[s:e], word[s:e])
        err = infer_errors_plain(filt, codes[s:e], 16, 7, trusted0=want)
        assert (r["err"] == err.numpy()).all()
        assert r["stats"]["walk_groups"] > r["stats"]["walk_rounds"] > 0
    assert _no_group()


@pytest.fixture(scope="module")
def odd(arrays):
    """The first 317 reads: they split unevenly over 2 and 4 ranks."""
    return ReadArrays(*(getattr(arrays, f)[:317] for f in
                        ("codes", "quals", "mask", "rgs", "seconds")))


@pytest.fixture(scope="module")
def jax_sharded(odd):
    """The JAX package's sharded bytes of `odd` at D devices, computed
    once each."""
    cache = {}

    def get(D):
        if D not in cache:
            cache[D] = j_run_pipeline(_jax(odd), JRecalConfig(**CFG),
                                      devices=D, bloom_layout="sharded")
        return cache[D]
    return get


WALK_DRIVES = [
    # ranks, engine, walk block rows, exchange chunk (chunk // 48 lanes a
    # group at k = 16)
    (2, "resident", 1, 1 << 22),     # a block a row
    (4, "resident", 37, 200),        # odd blocks, groups of 4 lanes
    (2, "windowed", 1 << 21, 100),   # a block over the data, 2-lane groups
    (4, "windowed", 23, 48),         # windows of 64 reads in blocks of 23
]


@pytest.mark.parametrize("drive", WALK_DRIVES,
                         ids=lambda d: f"{d[0]}ranks_{d[1]}_{d[2]}_{d[3]}")
def test_walk_blocks_and_lane_groups_keep_the_references_bytes(
        odd, jax_sharded, drive):
    """The resident path and the windowed engine (windows of 64 reads) on
    the ranks with walk blocks of one row, of odd sizes and larger than
    the data, and lane groups of one to four lanes: the JAX package's
    sharded bytes at the same D.  The ranks' rows differ in number (the
    reads do not split evenly).  The stats show at most three collectives
    per lane group."""
    from kbbq_tpu_torch.parallel.resident_sharded import (resident_rank,
                                                          run_ranks)
    from kbbq_tpu_torch.parallel.sharded import windowed_rank
    D, engine, walk_rows, chunk = drive
    cfg = RecalConfig(**CFG)
    assert odd.num_reads % D
    if engine == "resident":
        args = (resident_rank, plan_for(odd, cfg, "sharded", D), cfg, None)
    else:
        args = (windowed_rank, cfg, 0, None, None, 64, "sharded")
    t: dict = {}
    got = run_ranks(_rank_cases.with_walk, odd, D, "cpu", t, walk_rows,
                    chunk, *args)
    assert (got == jax_sharded(D)).all()
    assert 0 < t["walk_rounds"] < t["walk_groups"]
    assert t["walk_collectives"] <= 3 * t["walk_groups"]
    assert _no_group()


def test_a_device_count_not_a_power_of_two_is_refused(arrays, monkeypatch):
    """D = 3: each filter's m/32 words cannot split evenly.  The port
    refuses before any rank starts, asked for or picked by "auto"; the
    reference fails too, in JAX's placement of the filter over the mesh."""
    cfg = dict(CFG, batch_size=96)
    t0 = time.time()
    with pytest.raises(ValueError, match="power-of-two"):
        run_pipeline(arrays, RecalConfig(**cfg), device="cpu", devices=3,
                     bloom_layout="sharded")
    monkeypatch.setattr(sharded, "REPLICATED_BLOOM_BUDGET", 1 << 10)
    with pytest.raises(ValueError, match="power-of-two"):
        run_pipeline(arrays, RecalConfig(**cfg), device="cpu", devices=3)
    with pytest.raises(ValueError, match="power-of-two"):
        sharded.run_arrays_sharded(arrays, RecalConfig(**cfg), 3, "cpu",
                                   layout="sharded")
    assert time.time() - t0 < 5 and _no_group()     # no rank was started
    with pytest.raises(ValueError):
        j_run_pipeline(_jax(arrays), JRecalConfig(**cfg), devices=3,
                       bloom_layout="sharded")
    # the same count runs with the replicated layout
    assert sharded.resolve_layout("replicated", RecalConfig(**cfg), 1, 1,
                                  3) == "replicated"


def test_checkpoint_at_four_ranks_resumes_at_two(arrays, one, tmp_path):
    """run_pipeline's route with a checkpoint (the windowed engine on the
    ranks, windows of 64 reads): at 4 ranks it writes the reference's
    rows_a_sharded / rows_b_sharded files (the JAX package's own run at 4
    devices writes the same words) and one device's bytes; resumed after
    pass 2 at 2 ranks, from those files, the same bytes again."""
    cfg = RecalConfig(**CFG)
    ck, ckj = tmp_path / "port", tmp_path / "jax"
    got4 = run_pipeline(arrays, cfg, device="cpu", devices=4,
                        bloom_layout="sharded", checkpoint_dir=str(ck))
    assert (got4 == one).all()
    j_run_pipeline(_jax(arrays), JRecalConfig(**CFG), devices=4,
                   bloom_layout="sharded", checkpoint_dir=str(ckj))
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["passes_done"] == ["rows_a_sharded", "rows_b_sharded",
                                   "covariates"]
    for name in ("rows_a_sharded", "rows_b_sharded", "cov_cyc_total",
                 "cov_din_errors"):
        assert (np.load(ck / f"{name}.npy") ==
                np.load(ckj / f"{name}.npy")).all(), name
    meta["passes_done"] = ["rows_a_sharded", "rows_b_sharded"]
    (ck / "meta.json").write_text(json.dumps(meta))
    got2 = run_pipeline(arrays, cfg, device="cpu", devices=2,
                        bloom_layout="sharded", checkpoint_dir=str(ck))
    assert (got2 == one).all()
    assert json.loads((ck / "meta.json").read_text())["passes_done"] == [
        "rows_a_sharded", "rows_b_sharded", "covariates"]
    assert _no_group()


def test_plain_walk_with_a_query_callable_equals_infer_errors_plain(hashed):
    """walk_plain with the local query, and infer_errors_sharded with the
    local exchange (RoundWalkPlain, the walk_round kernel's plain version:
    lane groups of one lane, of a few, of every lane), give
    infer_errors_plain's marks, at the default extension and at W < k; with
    no rows it still takes part in every group the agreement asks for,
    asking nothing."""
    codes, h1, word, filt = hashed
    tr0 = tb.bloom_query_words_plain(filt, h1, word)
    for W in (16, 5):
        want = infer_errors_plain(filt, codes, 16, 7, W, trusted0=tr0)
        assert want.any()
        got = walk_plain(lambda hi, lo: _query_rows_w(filt, hi, lo, 7),
                         codes, 16, W, tr0)
        assert torch.equal(got, want)
        got = walk_plain(lambda hi, lo: _query_rows_w(filt, hi, lo, 7),
                         codes, 16, W)
        assert torch.equal(got, want)
        for group in (1, 7, 1 << 16):
            ex = LocalExchange(filt)
            stats = {"walk_rounds": 0, "lanes_by_round": []}
            got = infer_errors_sharded(codes, tr0, ex, 16, 7, W, group,
                                       stats)
            rounds = stats["walk_rounds"]
            assert torch.equal(got, want) and rounds > 1
            # a group a round and the last agreement, or more
            assert ex.groups == rounds + 1 if group > 1000 else \
                ex.groups > rounds + 1
            assert ex.groups >= sum(-(-n // group)
                                    for n in stats["lanes_by_round"]) + 1

    class Others:
        """Two owners, the other rank walking for three more groups."""
        owners, shift = 2, 15

        def __init__(self):
            self.rows, self.agreed = [], iter([0, 0, 0, None])

        def exchange(self, row, pairs):
            self.rows.append(row.tolist())
            mine = next(self.agreed)
            return None if mine is None else (
                torch.zeros(0, dtype=torch.uint8), mine)
    ex = Others()
    empty = infer_errors_sharded(codes[:0], tr0[:0], ex, 16, 7, None, 8)
    assert empty.shape == (0, codes.shape[1])
    assert ex.rows == [[0, 0, 0]] * 4


def test_sharded_params_bump_and_the_keep_planes(hashed):
    """The bump of ShardedBloomRecalPipeline from the one-device sizes (the
    floor 2^(5 + D.bit_length() + 5) bits, over the filters' own floor of
    2^16 from D = 64 on), refused for D not a power of two; and pass 1's
    keep planes (``hash_keep``) are the hash pass's at the rows' global
    ordinals, however the rows are split."""
    cfg = RecalConfig(k=16, coverage=20.0)
    for D in (1, 2, 4, 8, 16, 32, 64):
        pa, pb = sharded_params(cfg, 10, 0.5, 20.0, D)
        assert pa.log2_m == pb.log2_m == max(16, 10 + D.bit_length())
    with pytest.raises(ValueError, match="power-of-two"):
        sharded_params(cfg, 10, 0.5, 20.0, 6)
    from kbbq_tpu_torch.ops.hash_cache import hash_keep
    codes = hashed[0]
    want = hash_cache_chunk(codes, torch.arange(codes.shape[0]), 16, 7,
                            0x7FFFFFFF)
    for s in (0, 7, 100):
        got = hash_keep(codes[s:], s, 16, 7, 0x7FFFFFFF, chunk_rows=33)
        assert all(torch.equal(a, b[s:]) for a, b in zip(got, want))


def test_routes_at_four_ranks(arrays, tmp_path, monkeypatch):
    """The streamed FASTQ route (windows of 64 reads, so the ranks own
    different numbers of windows and step in lockstep), the windowed and
    whole-file BAM routes and the CRAM route with bloom_layout="sharded" at
    4 ranks: one device's bytes, and on the streamed FASTQ route the JAX
    package's sharded bytes at 4 devices."""
    from kbbq_tpu.pipeline.streaming import (
        recalibrate_fastq_streaming as j_streaming)
    from kbbq_tpu_torch.pipeline import (recalibrate_bam,
                                         recalibrate_bam_streaming,
                                         recalibrate_cram,
                                         recalibrate_fastq_streaming)
    from kbbq_tpu_torch.utils.synth import (arrays_to_bam_bytes,
                                            arrays_to_cram_bytes,
                                            arrays_to_fastq_bytes,
                                            make_arrays_fast, read_starts)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)   # CRAM's gzip stamps
    fq = tmp_path / "in.fq"
    fq.write_bytes(arrays_to_fastq_bytes(arrays))
    cfg = RecalConfig(**CFG)
    outs = {}
    for name, kw in (("one", {}), ("four", dict(devices=4,
                                                 bloom_layout="sharded"))):
        outs[name] = tmp_path / f"{name}.fq"
        recalibrate_fastq_streaming(str(fq), str(outs[name]), cfg,
                                    chunk_reads=64, device="cpu", **kw)
    j4 = tmp_path / "j4.fq"
    j_streaming([str(fq)], str(j4), JRecalConfig(**CFG), chunk_reads=64,
                devices=4, bloom_layout="sharded")
    assert outs["four"].read_bytes() == outs["one"].read_bytes() == \
        j4.read_bytes()
    a, _ = make_arrays_fast(genome_len=4000, read_len=41, num_reads=600,
                            seed=1)
    starts = read_starts(4000, 41, 600, 1)
    (tmp_path / "in.bam").write_bytes(arrays_to_bam_bytes(
        a, starts, extra_share=0.1)[0])
    (tmp_path / "in.cram").write_bytes(arrays_to_cram_bytes(
        a, starts, extra_share=0.1, records_per_container=128)[0])
    bcfg = RecalConfig(k=16, coverage=18.0, batch_size=64)
    for route, src, ext, extra in (
            (recalibrate_bam_streaming, "in.bam", "bam",
             dict(set_oq=True, chunk_records=100)),
            (recalibrate_bam, "in.bam", "bam", dict(set_oq=True)),
            (recalibrate_cram, "in.cram", "cram", {})):
        got = []
        for kw in ({}, dict(devices=4, bloom_layout="sharded")):
            out = tmp_path / f"{route.__name__}{len(got)}.{ext}"
            route(str(tmp_path / src), str(out), bcfg, device="cpu",
                  **extra, **kw)
            got.append(out.read_bytes())
        assert got[0] == got[1], route.__name__
    assert _no_group()

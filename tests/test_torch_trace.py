"""The port's tracer (``kbbq_tpu_torch/utils/trace.py``) on the entry points
of the whole-file FASTQ and BAM routes and of the streamed FASTQ route, on
the CPU at a small size.  Off (``timings=None``) it reads no clock and opens
no profiler range; on, every span named below is there and nests in its
parent, the top-level stages cover the call, the byte counters equal the
files' sizes, the BAM routes count the records of the per-record route
once a job, no stage sums the mask for the read lengths
(``arrays.lens_from_mask``), the output bytes and the stage keys are as
without it, and a profiler trace shows the records' ranges.
"""

import collections
import gzip
import io
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from kbbq_tpu_torch.io import bam as kbam
from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_bam,
                                     recalibrate_bam_streaming,
                                     recalibrate_fastq,
                                     recalibrate_fastq_streaming)
from kbbq_tpu_torch.utils import synth
from kbbq_tpu_torch.utils.metrics import profile_trace
from kbbq_tpu_torch.utils import trace as ktrace

torch.set_num_threads(2)

CFG = dict(k=16, coverage=30.0)
N, L = 600, 60
KINDS = ["fastq", "bam", "streamed"]

# span -> the names its parent may have (None: a top-level stage)
PASSES = {"setup": None, "pass1": None, "pass2": None, "pass3": None,
          "deltas": None, "pass4": None, "d2h.copy": {"pass3", "pass4"}}
SPANS = {
    "fastq": {**PASSES, "read": None, "fastq.load": {"read"},
              "fastq.index": {"read"}, "fastq.extract": {"read"},
              "fastq.pairing": {"read"}, "route": None, "h2d": None,
              "h2d.copy": {"h2d"}, "write": None,
              "fastq.render": {"write"}, "fastq.sink": {"write"}},
    "bam": {**PASSES, "read": None, "bam.load": {"read"},
            "bgzf.inflate": {"read"}, "decode": None,
            "bam.index": {"decode"}, "bam.scan": {"decode"},
            "bam.decode": {"decode"}, "route": None, "h2d": None,
            "h2d.copy": {"h2d"}, "release": None, "rewrite": None,
            "write": None, "bgzf.deflate": {"write"}, "bam.sink": {"write"}},
    "streamed": {**PASSES, "scan": None, "h2d.copy": {"pass1"},
                 "stream.read": {"pass1"},
                 "stream.prefetch_wait": {"pass1"},
                 "stream.render": {"pass4"},
                 "stream.writer_wait": {"pass4"}},
}
# the stage keys the entry points wrote before the tracer
STAGES = {
    "fastq": ["read", "setup", "h2d", "pass1", "pass2", "pass3", "deltas",
              "pass4", "write"],
    "bam": ["read", "decode", "setup", "h2d", "pass1", "pass2", "pass3",
            "deltas", "pass4", "rewrite", "write"],
    "streamed": ["scan", "setup", "pass1", "pass2", "pass3", "deltas",
                 "pass4"],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    arrays, _ = synth.make_arrays_fast(genome_len=3000, read_len=L,
                                       num_reads=N, seed=11)
    fq = str(d / "in.fq")
    synth.arrays_to_fastq_file(arrays, fq)
    data, _ = synth.arrays_to_bam_bytes(
        arrays, synth.read_starts(3000, L, N, seed=11))
    bam = d / "in.bam"
    bam.write_bytes(data)
    return {"fastq": fq, "bam": str(bam), "streamed": fq}


def run(kind, inputs, timings):
    """One job of `kind` into memory -> its output bytes."""
    sink = io.BytesIO()
    cfg = RecalConfig(**CFG)
    if kind == "fastq":
        recalibrate_fastq(inputs[kind], sink, cfg, device="cpu",
                          timings=timings)
    elif kind == "bam":
        recalibrate_bam(inputs[kind], sink, cfg, device="cpu",
                        timings=timings, set_oq=True)
    else:
        recalibrate_fastq_streaming(inputs[kind], sink, cfg, device="cpu",
                                    timings=timings, chunk_reads=250)
    return sink.getvalue()


@pytest.fixture(scope="module")
def jobs(inputs, tmp_path_factory):
    """Per kind, lazily: the untraced output, and a traced job run under
    ``profile_trace`` on the CPU: (untraced output, traced output,
    timings, the call's wall seconds, the profiler's ``kbbq.`` events)."""
    cache = {}

    def get(kind):
        if kind not in cache:
            off = run(kind, inputs, None)
            timings = {}
            path = tmp_path_factory.mktemp("prof") / f"{kind}.json"
            with profile_trace(str(path)) as p:
                t0 = time.perf_counter()
                on = run(kind, inputs, timings)
                wall = time.perf_counter() - t0
            events = [e for e in p.events()
                      if e.name.startswith(ktrace.PREFIX)]
            cache[kind] = (off, on, timings, wall, events)
        return cache[kind]
    return get


@pytest.mark.parametrize("kind", KINDS)
def test_off_reads_no_clock_and_opens_no_range(kind, inputs, jobs,
                                               monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the tracer ran with timings=None")

    want = jobs(kind)[0]
    monkeypatch.setattr(ktrace, "_clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert run(kind, inputs, None) == want
    assert ktrace.tracer(None, "cpu") is ktrace.OFF
    assert ktrace.OFF.span("x", device=True) is ktrace.OFF


@pytest.mark.parametrize("kind", KINDS)
def test_every_span_nests_in_its_parent_and_stages_cover_the_call(kind,
                                                                  jobs):
    _, _, timings, wall, _ = jobs(kind)
    spans = timings["spans"]
    by_id = {r["id"]: r for r in spans}
    assert {r["name"] for r in spans} == set(SPANS[kind])
    for r in spans:
        want = SPANS[kind][r["name"]]
        assert r["start"] <= r["end"], r
        if want is None:
            assert r["parent"] is None, r
            continue
        p = by_id[r["parent"]]
        assert p["name"] in want, (r, p)
        assert p["start"] <= r["start"] and r["end"] <= p["end"], (r, p)
    stages = sorted((r for r in spans if r["parent"] is None),
                    key=lambda r: r["start"])
    for a, b in zip(stages, stages[1:]):
        assert a["end"] <= b["start"]          # one stage at a time
    covered = sum(r["end"] - r["start"] for r in stages)
    assert covered >= 0.99 * wall, (covered, wall)


@pytest.mark.parametrize("kind", KINDS)
def test_byte_counters_equal_the_files(kind, inputs, jobs):
    _, out, timings, _, _ = jobs(kind)
    c = timings["counters"]
    if kind == "bam":
        raw_in = gzip.decompress(open(inputs[kind], "rb").read())
        assert c["bam.raw_in_bytes"] == len(raw_in)
        assert c["bam.raw_out_bytes"] == len(gzip.decompress(out))
        reads = N                       # every primary record is a row
    else:
        if kind == "fastq":
            assert c["fastq.in_bytes"] == os.path.getsize(inputs[kind])
            assert c["fastq.out_bytes"] == len(out)
        reads = N
    # the decodes hand their read lengths on: no stage sums the mask
    if kind == "streamed":
        assert c.get("arrays.lens_from_mask", 0) == 0
    else:
        assert c["arrays.lens_from_mask"] == 0
    # codes, quals and mask a byte a base, int64 read group, bool second
    assert c["h2d_bytes"] == reads * (3 * L + 9)
    assert c["d2h_bytes"] >= reads * L            # pass 4, and the tables


@pytest.mark.parametrize("route", ["whole_file", "streamed"])
def test_walk_refused_counts_the_per_record_route_once_a_job(route, jobs,
                                                             tmp_path):
    """``bam.walk_refused``: the primary records whose aux chain the walk
    refused (untagged, a last Z value without its NUL), each once, on the
    whole-file route and on the streamed one with no host cache (each pass
    decodes the chunks again); 0 on the clean input."""
    assert jobs("bam")[2]["counters"]["bam.walk_refused"] == 0
    arrays, _ = synth.make_arrays_fast(genome_len=3000, read_len=L,
                                       num_reads=N, seed=11)
    refused = np.arange(N) % 7 == 3
    recs = [kbam.build_record(f"r{i}", arrays.codes[i], arrays.quals[i],
                              flag=0x40, rg=None if refused[i] else "g1",
                              aux_extra=b"XZZabc" if refused[i] else b"XAAx")
            for i in range(N)]
    path = tmp_path / "odd.bam"
    path.write_bytes(kbam.serialize_bam(kbam.BamFile(
        "@HD\tVN:1.6\n@RG\tID:g1\n", [("synth", 3000)], recs)))
    timings = {}
    if route == "whole_file":
        recalibrate_bam(str(path), io.BytesIO(), RecalConfig(**CFG),
                        device="cpu", timings=timings, set_oq=True)
    else:
        recalibrate_bam_streaming(str(path), io.BytesIO(), RecalConfig(**CFG),
                                  device="cpu", timings=timings,
                                  chunk_records=100, host_cache_bytes=0)
    assert timings["counters"]["bam.walk_refused"] == refused.sum() > 0


@pytest.mark.parametrize("kind", KINDS)
def test_outputs_and_stage_keys_are_as_without_the_tracer(kind, jobs):
    off, on, timings, _, _ = jobs(kind)
    assert on == off and len(on) > 0
    assert set(STAGES[kind]) <= set(timings)
    assert all(timings[s] >= 0 for s in STAGES[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_the_profiler_shows_each_record_as_a_range(kind, jobs):
    _, _, timings, _, events = jobs(kind)
    spans = timings["spans"]
    assert collections.Counter(e.name for e in events) == \
        collections.Counter(ktrace.PREFIX + r["name"] for r in spans)
    # the stages, in their order
    stage_names = [ktrace.PREFIX + r["name"] for r in
                   sorted(spans, key=lambda r: r["start"])
                   if r["parent"] is None]
    ranges = sorted((e for e in events if e.name in set(stage_names)),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in ranges] == stage_names


def test_streamed_reads_and_renders_on_threads_of_their_own(jobs):
    _, _, timings, _, _ = jobs("streamed")
    me = threading.get_ident()
    threads = collections.defaultdict(set)
    for r in timings["spans"]:
        threads[r["name"]].add(r["thread"])
    assert threads["stream.read"] and me not in threads["stream.read"]
    assert threads["stream.render"] and me not in threads["stream.render"]
    assert threads["pass1"] == threads["stream.prefetch_wait"] == {me}
    windows = -(-N // 250)
    assert sum(r["name"] == "stream.render" for r in timings["spans"]) \
        == windows
    # one read a window, and the call that finds the end of the input
    assert sum(r["name"] == "stream.read" for r in timings["spans"]) \
        == windows + 1


def test_nested_calls_share_the_jobs_tracer_and_threads_count_safely():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _nested_and_threads()
    finally:
        sys.setswitchinterval(switch)


def _nested_and_threads():
    timings: dict = {}
    with ktrace.tracer(timings, "cpu") as outer:
        outer.stage("read")
        with ktrace.tracer(timings, "cpu") as inner:
            assert inner is outer
            inner.stage("write")
        other = {}
        with ktrace.tracer(other, "cpu") as own:
            assert own is not outer
        parent = outer.current()

        def work():
            for _ in range(200):
                with outer.span("stream.render", parent=parent):
                    outer.count("n", 1)
        ts = [threading.Thread(target=work) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    assert timings["counters"] == {"n": 3200}
    assert [r["name"] for r in timings["spans"][:2]] == ["read", "write"]
    renders = [r for r in timings["spans"] if r["name"] == "stream.render"]
    assert len(renders) == 3200
    assert {r["parent"] for r in renders} == {timings["spans"][1]["id"]}
    assert [r["name"] for r in other["spans"]] == []
    assert np.isclose(timings["read"] + timings["write"],
                      sum(r["end"] - r["start"] for r in timings["spans"][:2]),
                      atol=2e-3)


def test_a_process_that_never_used_the_card_is_not_made_to():
    # the parent of several ranks: its stages are timed, and the tracer
    # does not start the card's runtime where nothing else has
    used = torch.cuda.is_initialized()
    timings: dict = {}
    with ktrace.tracer(timings, "cuda") as trace:
        trace.stage("scan")
        trace.stage(None)
    assert torch.cuda.is_initialized() == used
    assert timings["scan"] >= 0
    assert ("scan_peak_bytes" in timings) == used
    assert [r["name"] for r in timings["spans"]] == ["scan"]

"""Streamed FASTQ in the port (io/stream.py, pipeline/stream_resident.py,
pipeline/streaming.py) against the JAX package and against the port's own
in-memory path.  The output does not depend on the chunk size, because
sampling keys on global read ordinals; the tests hold that for chunk sizes
of 37 reads, 1000 and more than the input, on the CPU (the kernels' plain
versions).  Tolerance: exact equality.
"""

import gzip

import numpy as np
import pytest

from kbbq_tpu.io import stream as jstream
from kbbq_tpu.io.fastq import read_fastq as j_read_fastq
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline import recalibrate_fastq as j_recalibrate_fastq
from kbbq_tpu.pipeline.streaming import (
    recalibrate_fastq_streaming as j_streaming)
from kbbq_tpu.utils.synth import make_dataset, to_fastq_bytes

from kbbq_tpu_torch.io import stream as tstream
from kbbq_tpu_torch.io.fastq import parse_fastq_bytes, read_fastq
from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_fastq,
                                     recalibrate_fastq_streaming)
from kbbq_tpu_torch.pipeline import stream_resident

CFG = dict(k=16, coverage=22.0, batch_size=64)


def _records(data: bytes, n: int) -> bytes:
    """The first n records of a FASTQ text."""
    lines = data.split(b"\n")
    return b"\n".join(lines[:4 * n]) + b"\n"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """a.fq: 359 paired reads of 55 bases (an odd count); b.fq.gz: reads of
    48 bases (all shorter than a's) and two shorter than k; c.fq: no read."""
    d = tmp_path_factory.mktemp("torch_stream")
    ds1 = make_dataset(genome_len=900, read_len=55, coverage=22.0,
                       error_rate=0.02, seed=41, paired=True, n_rate=0.01)
    ds2 = make_dataset(genome_len=700, read_len=48, coverage=18.0,
                       error_rate=0.02, seed=42)
    a, b, c = d / "a.fq", d / "b.fq.gz", d / "c.fq"
    a.write_bytes(_records(to_fastq_bytes(ds1), 359))
    b.write_bytes(gzip.compress(
        to_fastq_bytes(ds2)
        + b"@short1\nACGTACG\n+\nIIIIIII\n@short2\nAC\n+\n##\n"))
    c.write_bytes(b"")
    return d, [str(a), str(b), str(c)]


@pytest.fixture(scope="module")
def jax_out(files):
    """The JAX package's streamed and in-memory bytes for the three inputs
    into one sink, with and without interleaved pairing."""
    d, paths = files
    out = {}
    for inter in (False, True):
        s, r = d / f"js{inter}.fq", d / f"jr{inter}.fq"
        rep = {"report_out": str(d / "j.report")} if inter else {}
        j_streaming(paths, str(s), JRecalConfig(**CFG), chunk_reads=37,
                    interleaved=inter, **rep)
        out["stream_report", inter] = (d / "j.report").read_bytes() \
            if inter else None
        j_recalibrate_fastq(paths, str(r), JRecalConfig(**CFG),
                            interleaved=inter, **rep)
        out["memory_report", inter] = (d / "j.report").read_bytes() \
            if inter else None
        out["stream", inter] = s.read_bytes()
        out["memory", inter] = r.read_bytes()
    return out


# ------------------------------------------------------------ chunk reader

@pytest.mark.parametrize("chunk_reads", [1, 7, 1000, 359])
def test_chunk_reader_reassembles_exactly(files, chunk_reads):
    for path in files[1]:
        whole = read_fastq(path)
        parts = list(tstream.iter_fastq_chunks(path, chunk_reads))
        assert all(fq.num_reads <= chunk_reads for fq in parts)
        assert sum(fq.num_reads for fq in parts) == whole.num_reads
        assert b"".join(fq.buf.tobytes() for fq in parts) == \
            whole.buf.tobytes()
        jparts = list(jstream.iter_fastq_chunks(path, chunk_reads))
        assert [fq.num_reads for fq in parts] == \
            [fq.num_reads for fq in jparts]


@pytest.mark.parametrize("block_bytes", [3, 17, 1021])
def test_chunk_reader_tiny_blocks(tmp_path, block_bytes):
    """Cuts landing mid-block, on block edges and records over many
    blocks; ragged lengths and no last newline."""
    rng = np.random.default_rng(block_bytes)
    recs = []
    for i in range(97):
        m = int(rng.integers(1, 90))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), m))
        q = bytes((rng.integers(0, 40, m) + 33).astype(np.uint8))
        recs.append(b"@read_%d x\n%s\n+\n%s\n" % (i, seq, q))
    blob = b"".join(recs)[:-1]
    p = tmp_path / "fuzz.fq"
    p.write_bytes(blob)
    want = parse_fastq_bytes(blob).buf.tobytes()
    for chunk_reads in (1, 7, 97, 1000):
        got = b"".join(fq.buf.tobytes() for fq in tstream.iter_fastq_chunks(
            str(p), chunk_reads, block_bytes=block_bytes))
        assert got == want


def test_chunk_reader_truncated_raises(tmp_path):
    p = tmp_path / "trunc.fq"
    p.write_bytes(b"@r1\nACGT\n+\nIIII\n@r2\nACGT\n+\n")
    with pytest.raises(ValueError, match="truncated|multiple of 4"):
        list(tstream.iter_fastq_chunks(str(p), 10))


def test_scan_equals_the_jax_scan(files):
    _, paths = files
    for k in (16, 32):
        mine = tstream.scan_fastq_files(paths, k, chunk_reads=13)
        theirs = jstream.scan_fastq_files(paths, k, chunk_reads=13)
        for f in ("per_file_reads", "per_file_bases", "max_len",
                  "per_file_crc", "num_reads", "total_bases"):
            assert getattr(mine, f) == getattr(theirs, f), f
        assert mine.total_kmers(k) == theirs.total_kmers(k)
    assert mine.per_file_reads == [359, mine.per_file_reads[1], 0]
    assert mine.max_len == 55


@pytest.mark.parametrize("inter", [False, True])
def test_chunk_arrays_equal_the_jax_packages(files, inter):
    _, paths = files
    fq = next(tstream.iter_fastq_chunks(paths[1], 40))
    jfq = next(jstream.iter_fastq_chunks(paths[1], 40))
    for a, b in zip(tstream.chunk_to_batch_arrays(fq, 60, 1, 359, inter),
                    jstream.chunk_to_batch_arrays(jfq, 60, 1, 359, inter)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_prefetch_hands_on_items_and_errors():
    assert list(tstream.prefetch_iter(iter(range(50)), depth=3)) == \
        list(range(50))

    def bad():
        yield 1
        raise KeyError("in the producer")

    it = tstream.prefetch_iter(bad())
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer"):
        next(it)


# ------------------------------------------------------------ pipeline

@pytest.mark.parametrize("chunk_reads", [37, 1000, 900])
def test_streamed_equals_jax_and_in_memory(files, jax_out, tmp_path,
                                           chunk_reads):
    """Three inputs into one sink (a gzip input, one of no reads, reads
    shorter than k): the JAX package's streamed bytes, and the port's
    in-memory bytes, for any chunk size (900 > all reads)."""
    _, paths = files
    out = tmp_path / "s.fq"
    info = recalibrate_fastq_streaming(paths, str(out), RecalConfig(**CFG),
                                       chunk_reads=chunk_reads, device="cpu")
    assert out.read_bytes() == jax_out["stream", False]
    assert info["streamed"] and info["read_groups"] == 3
    assert info["chunks"] == sum(-(-n // chunk_reads) for n in
                                 tstream.scan_fastq_files(
                                     paths, 16).per_file_reads)
    mem = tmp_path / "m.fq"
    recalibrate_fastq(paths, str(mem), RecalConfig(**CFG), device="cpu")
    assert mem.read_bytes() == out.read_bytes() == jax_out["memory", False]


@pytest.mark.parametrize("chunk_reads", [37, 1000])
def test_streamed_equals_in_memory_at_k32(files, tmp_path, chunk_reads):
    """k = 32 (the hi lane full): the streamed bytes are the in-memory
    path's, which tests/test_torch_pipeline.py holds to the JAX package."""
    _, paths = files
    cfg = RecalConfig(**{**CFG, "k": 32})
    out, mem = tmp_path / "s.fq", tmp_path / "m.fq"
    recalibrate_fastq_streaming(paths, str(out), cfg, chunk_reads=chunk_reads,
                                device="cpu")
    recalibrate_fastq(paths, str(mem), cfg, device="cpu")
    assert out.read_bytes() == mem.read_bytes()


def test_one_input_list_sink_gz_sink_and_writable(files, tmp_path):
    _, paths = files
    cfg = RecalConfig(**CFG)
    one, mem = tmp_path / "one.fq", tmp_path / "mem.fq"
    recalibrate_fastq_streaming(paths[0], str(one), cfg, chunk_reads=50,
                                device="cpu")
    recalibrate_fastq(paths[0], str(mem), cfg, device="cpu")
    assert one.read_bytes() == mem.read_bytes()
    # a list of outputs, one per input, a .gz one among them
    outs = [str(tmp_path / n) for n in ("a.fq", "b.fq.gz", "c.fq")]
    mems = [str(tmp_path / n) for n in ("ma.fq", "mb.fq.gz", "mc.fq")]
    recalibrate_fastq_streaming(paths, outs, cfg, chunk_reads=50,
                                device="cpu")
    recalibrate_fastq(paths, mems, cfg, device="cpu")
    for o, m in zip(outs, mems):
        assert open(o, "rb").read() == open(m, "rb").read()
    assert open(outs[2], "rb").read() == b""
    # one .gz sink for all three: the in-memory path's BGZF bytes
    gz, mgz = tmp_path / "all.fq.gz", tmp_path / "mall.fq.gz"
    recalibrate_fastq_streaming(paths, str(gz), cfg, chunk_reads=50,
                                device="cpu")
    recalibrate_fastq(paths, str(mgz), cfg, device="cpu")
    assert gz.read_bytes() == mgz.read_bytes()
    with open(tmp_path / "w.fq", "wb") as f:
        recalibrate_fastq_streaming(paths, f, cfg, chunk_reads=50,
                                    device="cpu")
    assert gzip.decompress(gz.read_bytes()) == \
        (tmp_path / "w.fq").read_bytes()
    with pytest.raises(ValueError, match="one output per input"):
        recalibrate_fastq_streaming(paths, outs[:2], cfg, device="cpu")


def test_report_out_and_apply_report(files, tmp_path):
    """report_out writes the in-memory path's report; apply_report runs
    pass 4 alone from it and writes the same bytes."""
    _, paths = files
    cfg = RecalConfig(**CFG)
    s_rep, m_rep = tmp_path / "s.report", tmp_path / "m.report"
    direct = tmp_path / "direct.fq"
    recalibrate_fastq_streaming(paths[:2], str(direct), cfg, chunk_reads=60,
                                report_out=str(s_rep), device="cpu")
    recalibrate_fastq(paths[:2], str(tmp_path / "m.fq"), cfg,
                      report_out=str(m_rep), device="cpu")
    assert s_rep.read_bytes() == m_rep.read_bytes()
    applied = tmp_path / "applied.fq"
    recalibrate_fastq_streaming(paths[:2], str(applied), cfg,
                                chunk_reads=60, apply_report=str(s_rep),
                                device="cpu")
    assert applied.read_bytes() == direct.read_bytes()


@pytest.mark.parametrize("host,device", [(0, 0), (5000, None), (None, 0),
                                         (0, None)])
def test_caches_on_or_off_change_nothing(files, jax_out, tmp_path, host,
                                         device):
    """Host chunk cache off (0), overflowing mid-stream (5,000 bytes) or
    on; device window cache off (0) or on: the same bytes."""
    _, paths = files
    out = tmp_path / "o.fq"
    kw = {} if host is None else {"host_cache_bytes": host}
    recalibrate_fastq_streaming(paths, str(out), RecalConfig(**CFG),
                                chunk_reads=41, device="cpu",
                                device_cache_bytes=device, **kw)
    assert out.read_bytes() == jax_out["stream", False]


def test_interleaved_parity_follows_each_jax_path(files, jax_out, tmp_path):
    """With a first file of an odd read count, interleaved pairing differs
    between the JAX package's two paths (streamed: parity of the global
    ordinal; in memory: parity within each file), so the later files'
    cycle covariates swap first and second of pair and the two GATK
    reports differ.  The recalibrated bytes do not: the swap is the same
    for every read of a read group.  The port reproduces each path."""
    _, paths = files
    assert jax_out["stream_report", True] != jax_out["memory_report", True]
    assert jax_out["stream", True] == jax_out["memory", True]
    s, m = tmp_path / "s.fq", tmp_path / "m.fq"
    rs, rm = tmp_path / "s.report", tmp_path / "m.report"
    recalibrate_fastq_streaming(paths, str(s), RecalConfig(**CFG),
                                chunk_reads=100, interleaved=True,
                                report_out=str(rs), device="cpu")
    recalibrate_fastq(paths, str(m), RecalConfig(**CFG), interleaved=True,
                      report_out=str(rm), device="cpu")
    assert rs.read_bytes() == jax_out["stream_report", True]
    assert rm.read_bytes() == jax_out["memory_report", True]
    assert s.read_bytes() == jax_out["stream", True]
    assert m.read_bytes() == jax_out["memory", True]


def test_engine_rehashes_in_passes_2_and_3(files, monkeypatch):
    """Per window: pass 1 builds with the fused entry point, passes 2 and 3
    re-hash with the hash-only mode (no window's cache outlives its pass),
    and the device window cache replays pass 1's staged windows."""
    _, paths = files
    calls = {"into": 0, "windows": 0, "stage": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(stream_resident, "hash_cache_into",
                        counting("into", stream_resident.hash_cache_into))
    monkeypatch.setattr(stream_resident, "hash_windows",
                        counting("windows", stream_resident.hash_windows))
    monkeypatch.setattr(stream_resident, "arrays_to_device",
                        counting("stage", stream_resident.arrays_to_device))
    scan = tstream.scan_fastq_files(paths, 16, 100)
    windows = sum(-(-n // 100) for n in scan.per_file_reads)
    for cache, stages in ((None, windows), (0, 4 * windows)):
        for name in calls:
            calls[name] = 0
        recalibrate_fastq_streaming(paths, "/dev/null", RecalConfig(**CFG),
                                    chunk_reads=100, device="cpu",
                                    device_cache_bytes=cache)
        assert calls == {"into": windows, "windows": 2 * windows,
                         "stage": stages}


def test_in_memory_windowed_engine_equals_resident(files):
    """run_pipeline's windowed route (here forced by a first ordinal of 0
    through the engine itself) gives the resident path's qualities, with
    windows of any size."""
    from kbbq_tpu_torch.pipeline import run_pipeline
    from kbbq_tpu_torch.pipeline.recalibrate import _load_fastq_arrays
    _, paths = files
    _, _, arrays = _load_fastq_arrays(paths[:2], False)
    want = run_pipeline(arrays, RecalConfig(**CFG), device="cpu")
    for batch_size in (64, 200_000):
        got = stream_resident.recalibrate_arrays_windowed(
            arrays, RecalConfig(**{**CFG, "batch_size": batch_size}),
            device="cpu")
        assert np.array_equal(got, want)
    src = stream_resident.ArraysWindowSource(arrays, 100, 7)
    assert [w[0] for w in src.windows()] == \
        list(range(7, 7 + arrays.num_reads, 100))


def test_streamed_entry_raises_without_a_card(files, monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        recalibrate_fastq_streaming(files[1][0], str(tmp_path / "o.fq"),
                                    RecalConfig(**CFG))
    assert not (tmp_path / "o.fq").exists()


def test_a_whole_read_is_the_jax_read(files):
    """The chunk reader's records are the whole-file reader's (names,
    sequences, qualities), also against the JAX package's reader."""
    _, paths = files
    whole = j_read_fastq(paths[1])
    i = 0
    for fq in tstream.iter_fastq_chunks(paths[1], 33):
        for r in range(fq.num_reads):
            assert fq.name_bytes(r) == whole.name_bytes(i)
            assert fq.seq_bytes(r) == whole.seq_bytes(i)
            assert fq.qual_bytes(r) == whole.qual_bytes(i)
            i += 1
    assert i == whole.num_reads


def test_input_of_no_reads(tmp_path):
    """An empty input: an empty output and the JAX package's summary."""
    src = tmp_path / "e.fq"
    src.write_bytes(b"")
    out, jout = tmp_path / "o.fq", tmp_path / "j.fq"
    info = recalibrate_fastq_streaming(str(src), str(out),
                                       RecalConfig(k=16), device="cpu")
    jinfo = j_streaming(str(src), str(jout), JRecalConfig(k=16))
    assert info == jinfo and info["chunks"] == 0
    assert out.read_bytes() == jout.read_bytes() == b""

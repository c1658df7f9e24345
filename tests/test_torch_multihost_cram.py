"""Several hosts in the port (kbbq_tpu_torch/parallel/multihost.py), BAM and
CRAM: the BGZF member index, virtual offsets, range reads and the writers'
part switches held against the JAX package's on the same files, then two
host processes over gloo through the command line (``tests/_host_cases.py``).
BAM: ``cat`` of the parts holds the single host's records (each part
flushes its own last BGZF block, so not its bytes), and the parts are the
JAX package's own two-process parts byte for byte; a host killed between
pass 1 and pass 2, then resumed.  CRAM, one slice and several a container:
``cat`` of the parts is the single host's streamed CRAM, with time.time
pinned in every process (gzip blocks stamp the clock).  FASTQ is in
tests/test_torch_multihost.py.  Tolerance: exact equality.
"""

import os
import time

import pytest

from kbbq_tpu.io import bam_stream as jstream
from kbbq_tpu.io import cram_write as jcw
from kbbq_tpu.parallel import multihost as jmh

from kbbq_tpu_torch.io import bam as tbam
from kbbq_tpu_torch.io import bam_stream as tstream
from kbbq_tpu_torch.io import cram_write as tcw
from kbbq_tpu_torch.io.cram_write import write_cram
from kbbq_tpu_torch.parallel import multihost as tmh
from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_bam_streaming,
                                     recalibrate_cram_stream_resident)

from _host_cases import crash_and_stop, run_hosts
from test_cram import _mixed_records
from test_multihost_driver import _write_test_bam

CFG = dict(k=16, coverage=20.0, batch_size=64)
ARGS = ["-k", "16", "-c", "20.0", "--batch-size", "64", "--multihost"]
CLOCK = 1.7e9
CHUNK = 150


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """tests/test_multihost_driver.py's BAM (600 records, 2 read groups,
    reverse strands, pairs, secondaries) and the port's single-host
    streamed output with OQ tags, in chunks of 150 records."""
    d = tmp_path_factory.mktemp("mh_bam")
    path = str(d / "in.bam")
    _write_test_bam(path)
    want = str(d / "want.bam")
    recalibrate_bam_streaming(path, want, RecalConfig(**CFG), set_oq=True,
                              chunk_records=CHUNK, device="cpu")
    return {"path": path, "want": want}


def _records(data: bytes):
    """The records of BGZF BAM bytes, each as its bytes."""
    from kbbq_tpu_torch.io.bgzf import decompress
    return [bytes(r.data)
            for r in tbam.parse_bam_bytes(decompress(data)).records]


def _cat(d, name, hosts=2):
    parts = sorted(p for p in os.listdir(d) if p.startswith(name + ".part-"))
    assert parts == [f"{name}.part-{h:04d}-of-{hosts:04d}"
                     for h in range(hosts)]
    return [open(os.path.join(d, p), "rb").read() for p in parts]


# ------------------------------------------------------------- helpers

@pytest.mark.parametrize("chunk", [1, 7, CHUNK, 600, 4096])
def test_member_index_voffsets_and_ranges_are_the_references(bam, chunk):
    """bgzf_member_index, the chunk offsets, voffset_for and the range read
    from each chunk to the end: the JAX package's, and the range's chunks
    are the whole file's from there on; a range past the file's end
    raises."""
    path = bam["path"]
    assert tstream.bgzf_member_index(path) == jstream.bgzf_member_index(path)
    members, total = tstream.bgzf_member_index(path)
    meta = tmh.scan_bam_multihost(path, 16, chunk)
    ref = jmh.scan_bam_multihost(path, 16, chunk)
    assert meta[:2] == ref[:2] and meta[3:] == ref[3:]
    assert [{**m} for m in meta[2]] == [
        {k: int(v) for k, v in m.items()} for m in ref[2]]
    _, _, whole = tstream.iter_bam_raw_chunks(path, chunk)
    whole = [bytes(b) for b, _, _ in whole]
    metas = meta[2]
    for i in sorted({0, 1, len(metas) // 2, len(metas) - 1}
                    & set(range(len(metas)))):
        at = tstream.voffset_for(members, total, metas[i]["stream_off"])
        assert at == jstream.voffset_for(members, total,
                                         metas[i]["stream_off"])
        n = sum(m["n_records"] for m in metas[i:])
        got = [bytes(b) for b, _, _ in tstream.iter_bam_raw_chunks_range(
            path, *at, n - 1, chunk)]
        assert b"".join(got) == b"".join(whole[i:])[:len(b"".join(got))]
        assert got[:-1] == whole[i:i + len(got) - 1]
    # a range that outruns the file raises instead of yielding fewer records
    with pytest.raises(tstream.BAMError, match="before the end of its range"):
        list(tstream.iter_bam_raw_chunks_range(
            path, *tstream.voffset_for(members, total, metas[0]["stream_off"]),
            sum(m["n_records"] for m in metas) + 1, chunk))
    assert tstream.voffset_for(members, total, total)[1] == 0
    with pytest.raises(ValueError, match="out of range"):
        tstream.voffset_for(members, total, total + 1)


@pytest.mark.parametrize("header", [True, False])
@pytest.mark.parametrize("eof", [True, False])
def test_writers_part_switches_are_the_references(bam, tmp_path, header, eof,
                                                  monkeypatch):
    """BamStreamWriter and CramStreamWriter with each header / EOF switch:
    the JAX package's bytes (an unterminated BAM part flushes its last block
    without the marker); cat of a headed unterminated part and a headless
    terminated one is the whole file."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    _, _, chunks = tstream.iter_bam_raw_chunks(bam["path"], CHUNK)
    raws = [bytes(b) for b, _, _ in chunks]
    text = "@HD\tVN:1.6\n@RG\tID:g0\n@RG\tID:g1\n"
    refs = [("chr1", 3000)]
    for name, mod in (("t", tstream), ("j", jstream)):
        w = mod.BamStreamWriter(str(tmp_path / f"{name}.bam"), text, refs,
                                write_header=header, write_eof=eof)
        for r in raws:
            w.write_raw(r)
        w.close()
    got = (tmp_path / "t.bam").read_bytes()
    assert got == (tmp_path / "j.bam").read_bytes()
    assert got.endswith(tstream.BGZF_EOF) == eof
    bf = _mixed_records(seed=29, n=60)
    for name, mod in (("t", tcw), ("j", jcw)):
        w = mod.CramStreamWriter(str(tmp_path / f"{name}.cram"),
                                 bf.header_text, write_header=header,
                                 write_eof=eof)
        w.write_records(bf.records[:30])
        w.write_records(bf.records[30:])
        w.close()
    assert (tmp_path / "t.cram").read_bytes() == \
        (tmp_path / "j.cram").read_bytes()
    if header or eof:
        return
    parts = []
    for i, (h, e) in enumerate(((True, False), (False, True))):
        w = tstream.BamStreamWriter(str(tmp_path / f"p{i}"), text, refs,
                                    write_header=h, write_eof=e)
        for r in (raws[:2] if i == 0 else raws[2:]):
            w.write_raw(r)
        w.close()
        parts.append((tmp_path / f"p{i}").read_bytes())
    w = tstream.BamStreamWriter(str(tmp_path / "whole.bam"), text, refs)
    for r in raws:
        w.write_raw(r)
    w.close()
    assert _records(b"".join(parts)) == \
        _records((tmp_path / "whole.bam").read_bytes())


# ------------------------------------------------- two host processes

def test_two_hosts_bam_parts(bam, tmp_path):
    """Two hosts, each a contiguous run of chunks read from its virtual
    offset, with OQ tags: cat of the parts holds the single host's records
    in order, host 0's part the header, host 1's the EOF marker, and each
    part is the JAX package's two-process part byte for byte."""
    out = str(tmp_path / "out.bam")
    argv = ["recalibrate", bam["path"], "-o", out, *ARGS, "-s",
            "--chunk-reads", str(CHUNK)]
    stats = run_hosts(argv, tmp_path)
    parts = _cat(tmp_path, "out.bam")
    with open(bam["want"], "rb") as f:
        want = f.read()
    assert _records(b"".join(parts)) == _records(want)
    assert parts[0][:2] == b"\x1f\x8b" and parts[1].endswith(
        tstream.BGZF_EOF) and not parts[0].endswith(tstream.BGZF_EOF)
    n_prim = sum(1 for r in tbam.read_bam(bam["want"]).records
                 if not r.is_secondary_or_supp)
    assert sum(s["host_reads_written"] for s in stats) == n_prim
    assert all(s["part"].endswith(f"-of-0002") for s in stats)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jout = str(jdir / "out.bam")
    run_hosts(["recalibrate", bam["path"], "-o", jout, *ARGS, "-s",
               "--chunk-reads", str(CHUNK)], jdir, jax=True)
    assert _cat(jdir, "out.bam") == parts


def test_a_killed_bam_host_resumes_from_pass_1(bam, tmp_path):
    """Host 1 killed between pass 1 and pass 2, host 0 killed waiting on
    it; the rerun loads pass 1 (its file not rewritten) and the parts hold
    the single host's records."""
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "out.bam")
    argv = ["recalibrate", bam["path"], "-o", out, *ARGS, "-s",
            "--chunk-reads", str(CHUNK), "--checkpoint-dir", ck]
    rows_a = os.path.join(ck, "mh_rows_a.npy")
    crash_and_stop(argv, tmp_path, lambda: os.path.exists(rows_a))
    mtime = os.path.getmtime(rows_a)
    run_hosts(argv, tmp_path)
    with open(bam["want"], "rb") as f:
        assert _records(b"".join(_cat(tmp_path, "out.bam"))) == \
            _records(f.read())
    assert os.path.getmtime(rows_a) == mtime


@pytest.mark.parametrize("kind,layout", [("one_slice", "replicated"),
                                         ("multi_slice", "sharded")])
def test_two_hosts_cram_parts_are_the_single_hosts_bytes(tmp_path, kind,
                                                         layout,
                                                         monkeypatch):
    """Two hosts, each a contiguous run of containers: cat of the parts is
    the single host's streamed CRAM byte for byte (one slice a container,
    and several, whose windows are slice after slice), host 0's part with
    the file definition, host 1's with the EOF container."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    if kind == "one_slice":
        bf, kw = _mixed_records(seed=29, n=240), dict(
            records_per_container=32)
    else:
        bf, kw = _mixed_records(seed=31, n=200), dict(
            records_per_container=96, records_per_slice=24)
    cram = str(tmp_path / "in.cram")
    write_cram(bf, cram, **kw)
    want = str(tmp_path / "want.cram")
    recalibrate_cram_stream_resident(cram, want, RecalConfig(**CFG),
                                     device="cpu")
    out = str(tmp_path / "out.cram")
    stats = run_hosts(["recalibrate", cram, "-o", out, *ARGS,
                       "--bloom-layout", layout], tmp_path, clock=CLOCK)
    parts = _cat(tmp_path, "out.cram")
    assert b"".join(parts) == open(want, "rb").read()
    assert parts[0].startswith(b"CRAM") and not parts[1].startswith(b"CRAM")
    n_prim = len([r for r in bf.records
                  if not r.is_secondary_or_supp and r.l_seq > 0])
    assert sum(s["host_reads_written"] for s in stats) == n_prim
    assert all(s["windows"] > 0 for s in stats)

"""The port's benchmark, plot, metrics and config 4 generator against the
JAX package: ``benchmark_bam`` + ``write_tsv`` give the same TSV bytes on
the fixtures of tests/test_benchmark.py (BAM and CRAM, a recalibrated
FASTQ scored by name, CIGARs of every op), ``read_vcf_sites`` the same
sites, ``plot_benchmark`` its figure, ``Metrics`` the same lines and
records; ``make_arrays_chunked`` replays scripts/chr20.py's draws.
Tolerance: exact equality.
"""

import gzip
import io
import json
import os
import time

import numpy as np
import pytest

from kbbq_tpu import benchmark as jbench
from kbbq_tpu.io.bam import BamFile, build_record, read_bam, serialize_bam
from kbbq_tpu.io.cram_write import write_cram as j_write_cram
from kbbq_tpu.oracle.kmers import decode_seq
from kbbq_tpu.utils import metrics as jmetrics

from kbbq_tpu_torch import benchmark as tbench
from kbbq_tpu_torch.utils import metrics as tmetrics

from test_benchmark import _fixture

CLOCK = 1.7e9


def tsv_of(mod, *args, **kw):
    out = io.StringIO()
    mod.write_tsv(mod.benchmark_bam(*map(str, args), **kw), out)
    return out.getvalue()


def assert_same_tsv(*args, **kw):
    want = tsv_of(jbench, *args, **kw)
    assert tsv_of(tbench, *args, **kw) == want
    assert want.startswith("label\treportedQ\tactualQ\tcount\n")
    return want


def _mixed(tmp_path, n=60, seed=7):
    """Alignments with every CIGAR op, both strands, pass-through flags
    (unmapped, secondary, supplementary), a reference missing from the
    FASTA, and a FASTQ of other qualities for every second read (names
    with and without /1 /2)."""
    rng = np.random.default_rng(seed)
    G = 700
    genome = rng.integers(0, 4, G).astype(np.int8)
    ref = tmp_path / "ref.fa"
    ref.write_bytes(b">c1 x\n" + decode_seq(genome[:400]) + b"\n>c2\n"
                    + decode_seq(genome[400:]) + b"\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_bytes(b"#h\nc1\t31\t.\tACG\tA\nc2\t12\t.\tA\tT\n"
                    b"c1\tbad\t.\tA\tT\n")
    cigars = [[("M", 50)], [("S", 4), ("M", 40), ("I", 2), ("M", 4)],
              [("M", 20), ("D", 3), ("M", 30)], [("H", 5), ("M", 25),
                                                  ("N", 10), ("=", 20),
                                                  ("X", 5)],
              [("M", 30), ("P", 1), ("M", 20)]]
    recs, fq = [], []
    for i in range(n):
        cig = cigars[i % len(cigars)]
        L = sum(ln for op, ln in cig if op in "MIS=X")
        refid = (0, 1, 2)[i % 7 % 3]
        pos = int(rng.integers(0, 330 if refid != 1 else 230))
        seq = rng.integers(0, 4, L).astype(np.int8)
        span = genome[pos:pos + L] if refid == 0 else \
            genome[400 + pos:400 + pos + L]
        seq[:span.size] = span
        bad = rng.random(L) < 0.05
        seq[bad] = (seq[bad] + 1) % 4
        q = rng.integers(2, 42, L).astype(np.int8)
        flag = (0x10 if i % 2 else 0) | (0x4 if i == 5 else 0) | \
            (0x100 if i == 9 else 0) | (0x800 if i == 11 else 0)
        recs.append(build_record(f"m{i}", seq, q, flag=flag, refid=refid,
                                 pos=pos, cigar=cig))
        if i % 2 == 0:
            fq_q = rng.integers(2, 42, L)
            name = f"m{i}/1" if i % 4 else f"m{i}"
            fq.append(b"@" + name.encode() + b" c\n" + decode_seq(seq)
                      + b"\n+\n" + bytes((fq_q + 33).astype(np.uint8))
                      + b"\n")
    bam = tmp_path / "mixed.bam"
    bam.write_bytes(serialize_bam(BamFile(
        "@HD\tVN:1.6\n", [("c1", 400), ("c2", 300), ("c3", 100)], recs)))
    fastq = tmp_path / "m.fq"
    fastq.write_bytes(b"".join(fq))
    return bam, ref, vcf, fastq


def test_tsv_bytes_on_planted_errors_and_variable_sites(tmp_path):
    bam, ref, vcf, _ = _fixture(tmp_path)
    got = assert_same_tsv(bam, ref, vcf, label="kbbq-tpu")
    assert "\t20\t" in got
    novcf = tmp_path / "none.vcf"
    novcf.write_bytes(b"##fileformat=VCFv4.2\n#CHROM\tPOS\n")
    assert assert_same_tsv(bam, ref, novcf) != got


def test_tsv_bytes_on_every_cigar_op_and_a_fastq(tmp_path):
    bam, ref, vcf, fastq = _mixed(tmp_path)
    assert_same_tsv(bam, ref, vcf, label="bam")
    assert_same_tsv(bam, ref, vcf, fastq_path=str(fastq), label="fq")


def test_fastq_name_matching_without_collisions(tmp_path):
    for name in ("read1", "read11", "read1/1", "read11/2", "sample_001",
                 "x/3", "/2", ""):
        assert tbench._strip_pair_suffix(name) == \
            jbench._strip_pair_suffix(name)
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, 300).astype(np.int8)
    ref = tmp_path / "ref.fa"
    ref.write_bytes(b">c t\n" + decode_seq(genome) + b"\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_bytes(b"#h\n")
    recs = [build_record(name, genome[s:s + 50].copy(),
                         np.full(50, 30, np.int8), flag=0, refid=0, pos=s,
                         cigar=[("M", 50)])
            for name, s in (("read1", 0), ("read11", 100))]
    bam = tmp_path / "a.bam"
    bam.write_bytes(serialize_bam(BamFile("@HD\tVN:1.6\n", [("c", 300)],
                                          recs)))
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"@read1\n" + decode_seq(genome[:50]) + b"\n+\n"
                   + bytes([33 + 20] * 50) + b"\n@read11\n"
                   + decode_seq(genome[100:150]) + b"\n+\n"
                   + bytes([33 + 40] * 50) + b"\n")
    res = tbench.benchmark_bam(str(bam), str(ref), str(vcf),
                               fastq_path=str(fq))
    assert res["totals"][20] == 50 and res["totals"][40] == 50
    assert_same_tsv(bam, ref, vcf, fastq_path=str(fq))


@pytest.mark.parametrize("fixture", ["planted", "mixed"])
def test_tsv_bytes_on_cram_with_reconstructed_cigars(tmp_path, fixture,
                                                     monkeypatch):
    """The CRAM reader rebuilds CIGARs from features; the --reference
    FASTA doubles as the CRAM reference (reference-based slices)."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    if fixture == "planted":
        bam, ref, vcf, _ = _fixture(tmp_path)
    else:
        bam, ref, vcf, _ = _mixed(tmp_path)
    bf = read_bam(str(bam))
    if fixture == "planted":
        bf.header_text += "@SQ\tSN:chr1\tLN:500\n"
    else:
        bf.header_text += "".join(f"@SQ\tSN:{n}\tLN:{ln}\n"
                                  for n, ln in bf.refs)
    for rec in bf.records:
        rec._rg_index = 0
    cram = tmp_path / "aln.cram"
    j_write_cram(bf, str(cram), ref=jbench.read_fasta(str(ref)))
    want = assert_same_tsv(cram, ref, vcf)
    if fixture == "planted":
        assert want == tsv_of(jbench, bam, ref, vcf)
    from kbbq_tpu_torch.io.cram import read_cram
    got, _ = read_cram(str(cram), fasta_ref=str(ref))
    import struct
    for a, b in zip(bf.records, got.records):
        _, _, l_rn, _, _, n_cig = struct.unpack_from("<iiBBHH", b.data, 0)
        assert tbench.parse_cigar(b.data, 32 + l_rn, n_cig) == \
            jbench.parse_cigar(b.data, 32 + l_rn, n_cig)
        if fixture == "planted":
            assert tbench.parse_cigar(b.data, 32 + l_rn, n_cig) == \
                [("M", a.l_seq)]


def _vcf_lines(seed):
    rng = np.random.default_rng(seed)
    lines = [b"##fileformat=VCFv4.2", b"#CHROM\tPOS\tID\tREF\tALT"]
    for c in (b"chr1", b"chr22_random", b"chr2"):
        for p in np.sort(rng.choice(5000, 400, replace=False)) + 1:
            r = rng.random()
            if r < 0.15:
                ref = b"ACGTA"[: int(rng.integers(2, 6))]
                lines.append(c + b"\t%d\trs\t" % p + ref + b"\tA\t.\t.\t.")
            elif r < 0.2:
                lines.append(c + b"\t%d" % p)
            elif r < 0.25:
                lines.append(c + b"\t%dx\t.\tA\tG" % p)    # malformed POS
            else:
                lines.append(c + b"\t%d\t.\tA\tG\t9\tPASS\t." % p)
    lines.append(b"chrX\tbadpos\t.\tA\tG")
    lines.append(b"chrY\t\t.\tA\tG")
    return b"\n".join(lines) + b"\n"


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("block", [1 << 20, 257])
def test_read_vcf_sites_equals_the_jax_packages(tmp_path, gz, block):
    data = _vcf_lines(5)
    p = tmp_path / ("s.vcf.gz" if gz else "s.vcf")
    p.write_bytes(gzip.compress(data) if gz else data)
    want = jbench.read_vcf_sites(str(p), block_bytes=block)
    got = tbench.read_vcf_sites(str(p), block_bytes=block)
    assert set(got) == set(want) and len(want) == 3
    for c in want:
        assert got[c].dtype == want[c].dtype
        assert np.array_equal(got[c], want[c])


def test_fasta_is_the_jax_packages(tmp_path):
    p = tmp_path / "x.fa.gz"
    p.write_bytes(gzip.compress(b">a desc\nACGT\nacgt\n>b\nNNNN\n"))
    assert tbench.read_fasta(str(p)) == jbench.read_fasta(str(p)) == \
        {"a": b"ACGTACGT", "b": b"NNNN"}


def test_plot_writes_the_figure(tmp_path):
    pytest.importorskip("matplotlib")
    from kbbq_tpu_torch.plot import plot_benchmark
    bam, ref, vcf, _ = _fixture(tmp_path)
    tsv = tmp_path / "b.tsv"
    tsv.write_text(tsv_of(tbench, bam, ref, vcf))
    out = tmp_path / "plot.png"
    plot_benchmark(str(tsv), str(out))
    assert out.stat().st_size > 1000
    bad = tmp_path / "bad.tsv"
    bad.write_text("not\ta\tbenchmark\n")
    with pytest.raises(ValueError, match="not a kbbq benchmark TSV"):
        plot_benchmark(str(bad), str(tmp_path / "never.png"))


@pytest.mark.parametrize("as_json", [False, True])
def test_metrics_lines_and_records_equal_the_jax_packages(monkeypatch,
                                                          as_json):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:34:56")
    out = []
    for mod in (jmetrics, tmetrics):
        s = io.StringIO()
        m = mod.Metrics(stream=s, as_json=as_json)
        m.event("scan", reads=10, note="x")
        with m.pass_timer("pass1", 1000):
            pass
        out.append((s.getvalue(), m.records))
    assert out[1] == out[0]
    text, records = out[1]
    assert records[0] == {"ts": CLOCK, "event": "scan", "reads": 10,
                          "note": "x"}
    if as_json:
        assert [json.loads(ln) for ln in text.splitlines()] == records
    else:
        assert text.splitlines()[0] == \
            "[kbbq-tpu 12:34:56] scan reads=10 note=x"


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch
    path = tmp_path / "trace.json"
    with tmetrics.profile_trace(str(path)):
        torch.arange(1000).sum()
    trace = json.loads(path.read_text())
    assert trace["traceEvents"]


def test_peak_rss_bytes_reads_this_process(monkeypatch):
    before = tmetrics.peak_rss_bytes()
    big = np.ones(64 << 20, np.uint8)          # 64 MiB touched
    after = tmetrics.peak_rss_bytes()
    assert before > 0 and after >= before
    assert after >= big.nbytes
    del big
    real_open = open

    def no_vmhwm(path, *a, **kw):              # a /proc without VmHWM
        if path == "/proc/self/status":
            return io.StringIO("Name:\tpython\nVmRSS:\t1 kB\n")
        return real_open(path, *a, **kw)

    monkeypatch.setattr("builtins.open", no_vmhwm)
    assert tmetrics.peak_rss_bytes() is None


def _chr20_replay(reads, read_len, coverage, seed, step):
    """scripts/chr20.py::make_arrays' loop, replayed with its draws."""
    genome_len = max(1000, int(reads * read_len / coverage))
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    starts = rng.integers(0, genome_len - read_len + 1, size=reads)
    codes = np.empty((reads, read_len), np.int8)
    quals = np.empty((reads, read_len), np.int8)
    qpal = np.array([12, 20, 28, 37], dtype=np.int8)
    for s in range(0, reads, step):
        e = min(reads, s + step)
        idx = starts[s:e, None] + np.arange(read_len)
        c = genome[idx]
        quals[s:e] = qpal[rng.choice(4, size=(e - s, read_len),
                                     p=[0.1, 0.2, 0.3, 0.4])]
        err = rng.random((e - s, read_len)) < 0.005
        sub = (c + rng.integers(1, 4, size=c.shape)) % 4
        codes[s:e] = np.where(err, sub, c).astype(np.int8)
    return codes, quals


@pytest.mark.parametrize("reads,step", [(1000, 256), (1000, 1 << 20),
                                        (777, 100)])
def test_make_arrays_chunked_replays_the_chr20_draws(tmp_path, reads, step):
    from kbbq_tpu_torch.io.fastq import extract_padded_arrays, read_fastq
    from kbbq_tpu_torch.utils.synth import (arrays_to_fastq_bytes,
                                            arrays_to_fastq_file,
                                            make_arrays_chunked)
    a = make_arrays_chunked(reads, read_len=150, coverage=30.0, seed=0,
                            step=step)
    codes, quals = _chr20_replay(reads, 150, 30.0, 0, step)
    assert np.array_equal(a.codes, codes) and np.array_equal(a.quals, quals)
    assert a.mask.all() and not a.rgs.any()
    assert np.array_equal(a.seconds, np.arange(reads) % 2 == 1)
    path = tmp_path / "c.fq"
    size = arrays_to_fastq_file(a, str(path), step=300)
    assert path.read_bytes() == arrays_to_fastq_bytes(a)
    assert size == os.path.getsize(path) == reads * 318
    fq = read_fastq(str(path))
    c2, q2, _, _ = extract_padded_arrays(fq)
    assert np.array_equal(c2, codes) and np.array_equal(q2, quals)
    assert np.array_equal(fq.seconds_mask(), a.seconds)
    names = {fq.name_bytes(i) for i in range(fq.num_reads)}
    assert len(names) == reads

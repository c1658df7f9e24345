"""The frozen generators repeat by seed and give the program's generator's
reads and files at a small size (this test imports the program; the
benchmark's run does not)."""

import io

import numpy as np
import pytest

from bqsr_bench.harness import synth

SIZE = dict(genome_len=5000, read_len=150, num_reads=900, error_rate=0.005)


def test_same_seed_same_reads_other_seed_other_reads():
    a = synth.make_reads(**SIZE, seed=2 ** 31 + 5)
    b = synth.make_reads(**SIZE, seed=2 ** 31 + 5)
    c = synth.make_reads(**SIZE, seed=2 ** 31 + 6)
    for key in a:
        assert np.array_equal(a[key], b[key])
    assert not np.array_equal(a["codes"], c["codes"])


def test_negative_and_large_seeds_are_taken():
    assert synth.seed_of(-1) == 2 ** 64 - 1
    synth.make_reads(**SIZE, seed=-3)
    synth.make_reads(**SIZE, seed=2 ** 40)


def test_reads_and_fastq_equal_the_programs_generator():
    from kbbq_tpu_torch.utils import synth as prog
    arrays, _ = prog.make_arrays_fast(seed=11, paired=True, **SIZE)
    reads = synth.make_reads(**SIZE, seed=11)
    assert np.array_equal(reads["codes"], arrays.codes)
    assert np.array_equal(reads["quals"], arrays.quals)
    assert np.array_equal(reads["seconds"], arrays.seconds)
    assert np.array_equal(reads["starts"], prog.read_starts(
        SIZE["genome_len"], SIZE["read_len"], SIZE["num_reads"], 11))
    assert synth.fastq_bytes(reads["codes"], reads["quals"],
                             reads["seconds"]) == \
        prog.arrays_to_fastq_bytes(arrays)


def test_bam_equals_the_programs_generator(tmp_path):
    from kbbq_tpu_torch.io import bgzf
    from kbbq_tpu_torch.utils import synth as prog
    arrays, _ = prog.make_arrays_fast(seed=12, paired=True, **SIZE)
    reads = synth.make_reads(**SIZE, seed=12)
    want, rows = prog.arrays_to_bam_bytes(arrays, reads["starts"])
    path = tmp_path / "s.bam"
    lay = synth.write_bam(str(path), reads)
    got = path.read_bytes()
    assert np.array_equal(lay["rows"], rows)
    assert synth.bgzf_inflate(got) == bgzf.decompress(want)
    assert got == want


def test_expected_bam_with_oq_equals_the_programs_generator():
    from kbbq_tpu_torch.io import bgzf
    from kbbq_tpu_torch.utils import synth as prog
    arrays, _ = prog.make_arrays_fast(seed=13, paired=True, **SIZE)
    reads = synth.make_reads(**SIZE, seed=13)
    lay = synth.alignment_layout(reads)
    dec = synth.decode_order(reads, lay)
    # OQ on every record: the program's generator writes it on the copies
    # too; the recalibration's expected output only on primaries, so
    # compare the primary records
    want = bgzf.decompress(prog.arrays_to_bam_bytes(
        arrays, reads["starts"], oq_quals=arrays.quals)[0])
    got, starts, _ = synth.bam_stream(lay, None, dec["quals"])
    prim = np.flatnonzero(~lay["copy"])
    raw = np.frombuffer(want, np.uint8)
    head = len(synth.bam_header(lay))
    rec_w = (raw.size - head) // lay["src"].size
    mine = np.frombuffer(got, np.uint8)
    assert prim.size < lay["src"].size
    for j in prim:
        a = mine[starts[j]:starts[j] + rec_w]
        b = raw[head + j * rec_w:head + (j + 1) * rec_w]
        assert np.array_equal(a, b)


def test_bgzf_inflate_refuses_a_broken_stream():
    data = synth.bgzf_compress(b"x" * 100000)
    assert synth.bgzf_inflate(data) == b"x" * 100000
    with pytest.raises(ValueError):
        synth.bgzf_inflate(data[:-28])
    bad = bytearray(data)
    bad[30] ^= 0xFF
    with pytest.raises(ValueError):
        synth.bgzf_inflate(bytes(bad))
    with pytest.raises(ValueError):
        synth.bgzf_inflate(b"not bgzf" * 10)

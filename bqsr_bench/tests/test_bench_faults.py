"""The harness's check catches a broken timed path: the rest of a run is
driven on the CPU with the program's entry point broken underneath, and
``correct`` comes out false once for each fault a cell of this benchmark
can have.  (The exchange between cards does not exist in a one-card
cell.)"""

import shutil

import pytest

from bqsr_bench.tests.helpers import BAM, FASTQ, cpu_run, small_cell


def _program_entry(cell):
    from bqsr_bench.harness.runner import _entry
    return _entry(cell["traffic"]["entry"])


def unchanged(path, sink, cfg, **kw):
    """The state returned unchanged: the input written back as it was."""
    with open(path, "rb") as f:
        shutil.copyfileobj(f, sink)


def half_of_the_batch(entry):
    """The covariates counted over half of each chunk's reads only."""
    from kbbq_tpu_torch.pipeline import resident
    accumulate = resident.accumulate_covariates

    def broken(path, sink, cfg, **kw):
        def half(state, codes, quals, mask, rgs, seconds, errors):
            h = max(1, codes.shape[0] // 2)
            return accumulate(state, codes[:h], quals[:h], mask[:h], rgs[:h],
                              seconds[:h], errors[:h])
        resident.accumulate_covariates = half
        try:
            entry(path, sink, cfg, **kw)
        finally:
            resident.accumulate_covariates = accumulate
    return broken


def one_answer_altered(entry, fmt):
    """One new quality changed where it is written."""
    def broken(path, sink, cfg, **kw):
        import io
        buf = io.BytesIO()
        entry(path, buf, cfg, **kw)
        data = bytearray(buf.getvalue())
        if fmt == "fastq":
            at = data.index(b"\n+\n") + 3
            data[at] = data[at] + 1 if data[at] < 126 else data[at] - 1
        else:
            from bqsr_bench.harness import synth
            raw = bytearray(synth.bgzf_inflate(bytes(data)))
            at = _first_qual(raw)
            raw[at] = raw[at] + 1 if raw[at] < 93 else raw[at] - 1
            data = synth.bgzf_compress(bytes(raw))
        sink.write(bytes(data))
    return broken


def _first_qual(raw) -> int:
    """Offset of the first QUAL byte of the first record (a primary) of a
    BAM stream of 150-base reads named with 10 letters, one CIGAR op."""
    import struct
    off = 8 + struct.unpack_from("<i", raw, 4)[0] + 4
    off += 4 + struct.unpack_from("<i", raw, off)[0] + 4
    return off + 4 + 32 + 11 + 4 + 75


@pytest.mark.parametrize("name", [FASTQ, BAM])
@pytest.mark.parametrize("fault", ["unchanged", "half_of_the_batch",
                                   "one_answer_altered"])
def test_a_broken_timed_path_reads_not_correct(name, fault):
    cell = small_cell(name, num_reads=3000, genome_len=6000)
    entry = _program_entry(cell)
    broken = {"unchanged": lambda: unchanged,
              "half_of_the_batch": lambda: half_of_the_batch(entry),
              "one_answer_altered": lambda: one_answer_altered(
                  entry, cell["config"]["format"])}[fault]()
    res, out, err = cpu_run(name, entry=broken, cell=cell)
    assert not res["correct"]
    assert res["failed"] == res["attempted"] >= 1
    wrong = sum(c["value"] for c in res["checks"].values())
    assert wrong > 0
    if fault == "one_answer_altered":
        assert res["checks"]["qual_bytes_wrong"]["value"] == 1


def test_a_job_of_the_window_that_raises_reads_not_correct():
    cell = small_cell(FASTQ, num_reads=300)
    entry = _program_entry(cell)
    calls = []

    def raises(path, sink, cfg, **kw):
        calls.append(1)
        if len(calls) > 1:      # the warm-up job passes
            raise RuntimeError("broken")
        entry(path, sink, cfg, **kw)
    res, out, err = cpu_run(FASTQ, entry=raises, cell=cell)
    assert not res["correct"] and res["failed"] == 1
    assert "broken" in err

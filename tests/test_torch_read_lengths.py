"""The read lengths that travel with ``ReadArrays``: every producer of the
port (the FASTQ extract, the BAM and CRAM decodes, ``from_lists``, the
windowed engine's windows, the ranks' shared rows) gives ``lens`` equal to
the mask's row sums, so that no stage sums the mask again; where a
producer gave none, ``read_lengths`` sums it once and the tracer counts it
(``arrays.lens_from_mask``).  On the CPU at a small size.  Tolerance:
exact equality.
"""

import time

import numpy as np
import pytest
import torch

from kbbq_tpu.io.cram_write import write_cram as j_write_cram

from kbbq_tpu_torch.io.batcher import ReadArrays
from kbbq_tpu_torch.parallel import resident_sharded
from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_bam,
                                     recalibrate_bam_streaming,
                                     recalibrate_cram,
                                     recalibrate_cram_stream_resident,
                                     recalibrate_fastq,
                                     recalibrate_fastq_streaming,
                                     run_pipeline)
from kbbq_tpu_torch.pipeline import recalibrate as trecal
from kbbq_tpu_torch.pipeline import stream_resident
from kbbq_tpu_torch.utils import synth

from test_cram import _mixed_records
from test_torch_bam import bam_records, write_bam
from test_torch_native_io import _odd_names, _ragged

torch.set_num_threads(2)

CFG = dict(k=16, coverage=20.0)
COUNTER = "arrays.lens_from_mask"


def _lens_of_mask(arrays):
    return np.asarray(arrays.mask).sum(axis=1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """FASTQ files of ragged reads, a BAM of reads of two lengths with
    secondary copies and empty records, a CRAM of reads of 20-79 bases."""
    d = tmp_path_factory.mktemp("lens")
    fq1, fq2 = d / "a.fq", d / "b.fq"
    fq1.write_bytes(_ragged(11, n_reads=300, max_len=90))
    fq2.write_bytes(_odd_names(12, n_reads=200))
    bam = write_bam(d / "in.bam", bam_records())
    cram = d / "in.cram"
    j_write_cram(_mixed_records(seed=31, n=300), str(cram),
                 records_per_container=64, records_per_slice=24)
    return {"fq": [str(fq1), str(fq2)], "bam": bam, "cram": str(cram),
            "dir": d}


@pytest.fixture
def seen(monkeypatch):
    """Every ReadArrays that reaches ``run_pipeline`` or that the windowed
    engine stages, as the producers made it (before anything reads it)."""
    got = []
    real_run = trecal.run_pipeline
    real_window = stream_resident.window_arrays

    def run(arrays, *a, **kw):
        got.append((arrays, arrays.lens))
        return real_run(arrays, *a, **kw)

    def window(arrs):
        arrays = real_window(arrs)
        got.append((arrays, arrays.lens))
        return arrays

    monkeypatch.setattr(trecal, "run_pipeline", run)
    monkeypatch.setattr(stream_resident, "window_arrays", window)
    return got


def _check(seen):
    assert seen
    for arrays, lens in seen:
        assert lens is not None and lens.dtype == np.int64
        assert np.array_equal(lens, _lens_of_mask(arrays))


def _route(kind, inputs, timings=None):
    """One job of `kind` on the CPU into a file of the input's format."""
    cfg = RecalConfig(**CFG)
    d = inputs["dir"]
    kw = dict(device="cpu", timings=timings)
    if kind == "fastq":
        recalibrate_fastq(inputs["fq"], str(d / "o.fq"), cfg, **kw)
    elif kind == "fastq_one":
        recalibrate_fastq(inputs["fq"][0], str(d / "o1.fq"), cfg, **kw)
    elif kind == "fastq_streamed":
        recalibrate_fastq_streaming(inputs["fq"], str(d / "s.fq"), cfg,
                                    chunk_reads=120, **kw)
    elif kind == "bam":
        recalibrate_bam(inputs["bam"], str(d / "o.bam"), cfg, set_oq=True,
                        **kw)
    elif kind == "bam_streamed":
        recalibrate_bam_streaming(inputs["bam"], str(d / "s.bam"), cfg,
                                  chunk_records=70, **kw)
    elif kind == "cram":
        recalibrate_cram(inputs["cram"], str(d / "o.cram"), cfg, **kw)
    else:
        recalibrate_cram_stream_resident(inputs["cram"], str(d / "s.cram"),
                                         cfg, **kw)


@pytest.mark.parametrize("kind", ["fastq", "fastq_one", "fastq_streamed",
                                  "bam", "bam_streamed", "cram",
                                  "cram_streamed"])
def test_every_route_hands_on_the_lengths(kind, inputs, seen, monkeypatch):
    """The arrays of the whole-file routes (FASTQ extract, BAM and CRAM
    decode) and the windows of the streamed ones carry their lengths."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    _route(kind, inputs)
    _check(seen)
    if kind.startswith("fastq"):
        assert len({int(x) for x in seen[0][1]}) > 10   # ragged reads


@pytest.mark.parametrize("kind", ["fastq", "fastq_one", "bam", "cram"])
def test_no_mask_is_summed_on_the_whole_file_routes(kind, inputs,
                                                   monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    timings: dict = {}
    _route(kind, inputs, timings)
    assert timings["counters"][COUNTER] == 0


def test_windows_of_in_memory_arrays_and_checkpoints(inputs, seen,
                                                     tmp_path):
    """A checkpointed run of in-memory arrays takes the windowed engine:
    its windows carry the arrays' lengths, and the fingerprint's base
    count reads them."""
    from kbbq_tpu_torch.state.checkpoint import run_fingerprint
    arrays = ReadArrays.from_lists(
        [np.full(n, 1, np.int8) for n in (5, 40, 17, 0, 33) * 40],
        [np.full(n, 30, np.int8) for n in (5, 40, 17, 0, 33) * 40],
        np.zeros(200, np.int32), np.zeros(200, bool))
    timings: dict = {}
    run_pipeline(arrays, RecalConfig(**CFG, batch_size=512), device="cpu",
                 timings=timings, checkpoint_dir=str(tmp_path / "ck"))
    _check(seen)
    assert timings["counters"][COUNTER] == 0
    assert run_fingerprint(RecalConfig(**CFG), arrays)["total_bases"] == \
        int(_lens_of_mask(arrays).sum())


def test_from_lists_gives_the_lengths():
    codes = [np.zeros(n, np.int8) for n in (3, 0, 9, 9, 1)]
    arrays = ReadArrays.from_lists(codes, codes, [0] * 5, [False] * 5,
                                   max_len=12)
    assert arrays.lens.tolist() == [3, 0, 9, 9, 1]
    assert np.array_equal(arrays.lens, _lens_of_mask(arrays))


def test_a_hand_built_readarrays_is_summed_once_and_counted():
    arrays, _ = synth.make_arrays_fast(genome_len=3000, read_len=50,
                                       num_reads=300, seed=2)
    arrays.mask[::7, 30:] = False
    assert arrays.lens is None
    timings: dict = {}
    run_pipeline(arrays, RecalConfig(**CFG), device="cpu", timings=timings)
    assert timings["counters"][COUNTER] == 1
    assert np.array_equal(arrays.lens, _lens_of_mask(arrays))
    timings = {}
    run_pipeline(arrays, RecalConfig(**CFG), device="cpu", timings=timings)
    assert timings["counters"][COUNTER] == 0          # kept from the first
    assert arrays.read_lengths() is arrays.lens       # no tracer: no count


def test_the_ranks_shared_rows_carry_the_lengths():
    arrays, _ = synth.make_arrays_fast(genome_len=2000, read_len=30,
                                       num_reads=64, seed=4)
    arrays.mask[1::3, 20:] = False
    shared = resident_sharded.share_arrays(arrays)
    try:
        rows = resident_sharded.shared_rows(shared, 10, 50)
        assert np.array_equal(rows.lens, _lens_of_mask(arrays)[10:50])
        assert np.array_equal(rows.lens, _lens_of_mask(rows))
    finally:
        shared.close()

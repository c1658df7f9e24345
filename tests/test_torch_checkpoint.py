"""Pass-boundary checkpoints of the port (state/checkpoint.py and the
windowed engine) against the JAX package: the same fingerprints, the same
files, resume after every pass boundary and inside pass 4, refusal of a
changed config or input, resume from a checkpoint the JAX package wrote,
and the in-memory route for a first ordinal other than 0.  Tolerance:
exact equality.
"""

import json
import shutil

import numpy as np
import pytest

from kbbq_tpu.io.batcher import ReadArrays as JReadArrays
from kbbq_tpu.io.stream import scan_fastq_files as j_scan
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline.recalibrate import recalibrate_arrays
from kbbq_tpu.pipeline.streaming import (
    recalibrate_fastq_streaming as j_streaming)
from kbbq_tpu.state import checkpoint as jck
from kbbq_tpu.utils.synth import make_dataset, to_fastq_bytes

from kbbq_tpu_torch.io.batcher import ReadArrays
from kbbq_tpu_torch.io.stream import iter_fastq_chunks, scan_fastq_files
from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_fastq,
                                     recalibrate_fastq_streaming,
                                     run_pipeline)
from kbbq_tpu_torch.pipeline import stream_resident
from kbbq_tpu_torch.state import checkpoint as tck

CFG = dict(k=16, coverage=20.0, batch_size=64)
CHUNK = 90


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two FASTQ inputs (paired reads with N; a second of shorter reads)
    and the JAX package's streamed bytes for them, with the checkpoint
    directory that run wrote."""
    d = tmp_path_factory.mktemp("torch_ckpt")
    ds1 = make_dataset(genome_len=1000, read_len=60, coverage=20.0,
                       error_rate=0.02, seed=51, paired=True, n_rate=0.01)
    ds2 = make_dataset(genome_len=800, read_len=50, coverage=16.0,
                       error_rate=0.02, seed=52)
    a, b = d / "a.fq", d / "b.fq"
    a.write_bytes(to_fastq_bytes(ds1))
    b.write_bytes(to_fastq_bytes(ds2))
    paths = [str(a), str(b)]
    j_ck, j_out = d / "jax_ck", d / "jax.fq"
    j_streaming(paths, str(j_out), JRecalConfig(**CFG), chunk_reads=CHUNK,
                checkpoint_dir=str(j_ck))
    return d, paths, j_out.read_bytes(), j_ck


def _stream(paths, out, ck, **kw):
    return recalibrate_fastq_streaming(
        paths, str(out), RecalConfig(**{**CFG, **kw.pop("cfg", {})}),
        chunk_reads=CHUNK, checkpoint_dir=str(ck), device="cpu", **kw)


def _count_passes(monkeypatch):
    runs = []
    for name in ("run_pass1", "run_pass2", "run_pass3"):
        fn = getattr(stream_resident.StreamResidentEngine, name)

        def wrapped(self, fn=fn, name=name):
            runs.append(name)
            return fn(self)
        monkeypatch.setattr(stream_resident.StreamResidentEngine, name,
                            wrapped)
    return runs


# ------------------------------------------------------------ fingerprints

@pytest.mark.parametrize("kw", [{}, {"ext_cap": 5}, {"ext_cap": 40},
                                {"alpha": 0.3, "trust_threshold": 12},
                                {"k": 32, "genome_length": 900}])
def test_fingerprints_equal_the_jax_packages(data, kw):
    _, paths, _, _ = data
    cfg = {**CFG, **kw}
    mine, theirs = RecalConfig(**cfg), JRecalConfig(**cfg)
    assert tck.effective_ext_cap(mine) == jck.effective_ext_cap(theirs)
    k = cfg["k"]
    assert tck.stream_fingerprint(mine, paths, scan_fastq_files(paths, k)) \
        == jck.stream_fingerprint(theirs, paths, j_scan(paths, k))
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 5, (50, 40)).astype(np.int8)
    quals = rng.integers(0, 41, (50, 40)).astype(np.int8)
    mask = np.ones((50, 40), bool)
    rgs, sec = np.zeros(50, np.int32), rng.random(50) < 0.5
    assert tck.run_fingerprint(mine, ReadArrays(codes, quals, mask, rgs,
                                                sec)) == \
        jck.run_fingerprint(theirs, JReadArrays(codes, quals, mask, rgs,
                                                sec))


# ------------------------------------------------------------ streamed

def test_checkpoint_files_are_the_jax_packages(data, tmp_path):
    _, paths, want, j_ck = data
    ck, out = tmp_path / "ck", tmp_path / "o.fq"
    _stream(paths, out, ck)
    assert out.read_bytes() == want
    mine, theirs = (json.loads((c / "meta.json").read_text())
                    for c in (ck, j_ck))
    assert mine == theirs
    assert mine["passes_done"] == ["rows_a", "rows_b", "covariates"]
    assert mine["pass4"]["bytes"] == len(want)
    for name in ("rows_a", "rows_b", "cov_cyc_total", "cov_cyc_errors",
                 "cov_din_total", "cov_din_errors"):
        a, b = np.load(ck / f"{name}.npy"), np.load(j_ck / f"{name}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.load(ck / "rows_a.npy").dtype == np.uint32
    assert not list(ck.glob("*.tmp*"))


@pytest.mark.parametrize("kept", [0, 1, 2, 3])
def test_resume_after_each_pass_boundary(data, tmp_path, monkeypatch, kept):
    """A run stopped after `kept` passes resumes from there: the passes on
    disk are loaded, not run, and the output is the same."""
    _, paths, want, _ = data
    ck, out = tmp_path / "ck", tmp_path / "o.fq"
    _stream(paths, out, ck)
    meta = json.loads((ck / "meta.json").read_text())
    meta["passes_done"] = meta["passes_done"][:kept]
    del meta["pass4"]
    (ck / "meta.json").write_text(json.dumps(meta))
    out.write_bytes(b"stale")
    runs = _count_passes(monkeypatch)
    _stream(paths, out, ck)
    assert runs == ["run_pass1", "run_pass2", "run_pass3"][kept:]
    assert out.read_bytes() == want


def test_pass4_resumes_at_the_chunk_reached(data, tmp_path, monkeypatch):
    _, paths, want, _ = data
    ck, out = tmp_path / "ck", tmp_path / "o.fq"
    _stream(paths, out, ck)
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["pass4"]["chunks"] >= 3
    # a crash after chunk 1 of pass 4: its bytes are the input chunk's
    n0 = next(iter_fastq_chunks(paths[0], CHUNK)).buf.size
    meta["pass4"] = {"chunks": 1, "bytes": n0}
    (ck / "meta.json").write_text(json.dumps(meta))
    with open(out, "ab") as f:
        f.write(b"GARBAGE past the offset")
    written = []
    real = stream_resident.render_fastq_with_quals

    def spy(fq, nq, mask):
        written.append(fq.num_reads)
        return real(fq, nq, mask)
    monkeypatch.setattr(stream_resident, "render_fastq_with_quals", spy)
    runs = _count_passes(monkeypatch)
    _stream(paths, out, ck)
    assert runs == [] and out.read_bytes() == want
    total = json.loads((ck / "meta.json").read_text())["pass4"]["chunks"]
    assert len(written) == total - 1         # chunk 1 was not written again


def test_gz_sink_restarts_pass4(data, tmp_path):
    """A .gz sink is a compressed stream: pass 4 starts again at chunk 0
    and records no offset."""
    _, paths, want, _ = data
    ck, out = tmp_path / "ck", tmp_path / "o.fq.gz"
    _stream(paths, out, ck)
    import gzip
    assert gzip.decompress(out.read_bytes()) == want
    assert "pass4" not in json.loads((ck / "meta.json").read_text())
    first = out.read_bytes()
    _stream(paths, out, ck)
    assert out.read_bytes() == first


def test_mismatched_config_or_input_is_refused(data, tmp_path):
    _, paths, _, j_ck = data
    ck, out = tmp_path / "ck", tmp_path / "o.fq"
    _stream(paths, out, ck)
    with pytest.raises(ValueError, match="different parameters") as e:
        _stream(paths, out, ck, cfg={"k": 18})
    assert "mismatched: ext_cap, k)" in str(e.value)   # cap = min(32, k)
    with pytest.raises(ValueError, match="mismatched: chunk_reads"):
        recalibrate_fastq_streaming(paths, str(out), RecalConfig(**CFG),
                                    chunk_reads=CHUNK + 1,
                                    checkpoint_dir=str(ck), device="cpu")
    # a base changed in mid-file: same size and counts, another CRC
    src = tmp_path / "a.fq"
    shutil.copy(paths[0], src)
    text = bytearray(src.read_bytes())
    pos = text.index(b"\n", len(text) // 2)
    pos = text.index(b"\n@", pos) + 1
    pos = text.index(b"\n", pos) + 1              # the next sequence line
    text[pos] = ord("A") if text[pos] != ord("A") else ord("C")
    src.write_bytes(bytes(text))
    with pytest.raises(ValueError, match="mismatched: per_file_crc32"):
        _stream([str(src), paths[1]], out, ck)
    # the JAX package refuses the port's changed config the same way
    with pytest.raises(ValueError, match="different parameters"):
        j_streaming(paths, str(out), JRecalConfig(**{**CFG, "k": 18}),
                    chunk_reads=CHUNK, checkpoint_dir=str(j_ck))


@pytest.mark.parametrize("kept", [1, 3])
def test_resume_from_a_checkpoint_the_jax_package_wrote(data, tmp_path,
                                                        monkeypatch, kept):
    """The JAX package's streamed checkpoint (rows_a.npy, rows_b.npy,
    cov_*.npy), cut back to `kept` passes: the port loads those passes
    through state/convert.py, runs the rest, and writes JAX's bytes."""
    _, paths, want, j_ck = data
    ck, out = tmp_path / "ck", tmp_path / "o.fq"
    shutil.copytree(j_ck, ck)
    meta = json.loads((ck / "meta.json").read_text())
    meta["passes_done"] = meta["passes_done"][:kept]
    del meta["pass4"]
    (ck / "meta.json").write_text(json.dumps(meta))
    runs = _count_passes(monkeypatch)
    _stream(paths, out, ck)
    assert runs == ["run_pass2", "run_pass3"][:3 - kept]
    assert out.read_bytes() == want


# ------------------------------------------------------------ in memory

@pytest.fixture(scope="module")
def arrays():
    ds = make_dataset(genome_len=900, read_len=50, coverage=18.0,
                      error_rate=0.02, seed=47, paired=True, n_rate=0.01)
    return ds


@pytest.mark.parametrize("start", [1000, (1 << 32) - 100])
def test_start_ordinal_equals_the_jax_package(arrays, start):
    ds = arrays
    mine = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    theirs = JReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    got = run_pipeline(mine, RecalConfig(**CFG), device="cpu",
                       start_ordinal=start)
    want = recalibrate_arrays(theirs, JRecalConfig(**CFG),
                              start_ordinal=start)
    assert np.array_equal(got, np.asarray(want))
    assert not np.array_equal(got, run_pipeline(mine, RecalConfig(**CFG),
                                                device="cpu"))


def test_in_memory_checkpoint_and_resume(arrays, tmp_path, monkeypatch):
    ds = arrays
    a = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    want = run_pipeline(a, RecalConfig(**CFG), device="cpu")
    ck = tmp_path / "ck"
    got = run_pipeline(a, RecalConfig(**CFG), device="cpu",
                       checkpoint_dir=str(ck))
    assert np.array_equal(got, want)
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["fingerprint"] == jck.run_fingerprint(
        JRecalConfig(**CFG),
        JReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds))
    assert meta["passes_done"] == ["rows_a", "rows_b", "covariates"]
    assert np.load(ck / "rows_b.npy").dtype == np.uint32
    runs = _count_passes(monkeypatch)
    again = run_pipeline(a, RecalConfig(**CFG), device="cpu",
                         checkpoint_dir=str(ck))
    assert runs == [] and np.array_equal(again, want)
    a.codes[len(ds.codes) // 2, 3] = (a.codes[len(ds.codes) // 2, 3] + 1) % 4
    with pytest.raises(ValueError, match="mismatched: content_crc32"):
        run_pipeline(a, RecalConfig(**CFG), device="cpu",
                     checkpoint_dir=str(ck))


def test_recalibrate_fastq_with_checkpoint_dir(data, tmp_path):
    _, paths, _, _ = data
    plain, ckd = tmp_path / "plain.fq", tmp_path / "ck.fq"
    recalibrate_fastq(paths, str(plain), RecalConfig(**CFG), device="cpu")
    for _ in range(2):
        recalibrate_fastq(paths, str(ckd), RecalConfig(**CFG), device="cpu",
                          checkpoint_dir=str(tmp_path / "ck"))
        assert ckd.read_bytes() == plain.read_bytes()


def test_routes_of_run_pipeline(arrays, monkeypatch):
    """The resident path unless a checkpoint, a first ordinal or the card's
    free memory asks for the windowed engine."""
    from kbbq_tpu_torch.pipeline import recalibrate as rec
    ds = arrays
    a = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    seen = []
    real = stream_resident.recalibrate_arrays_windowed

    def spy(*args, **kw):
        seen.append(kw.get("start_ordinal"))
        return real(*args, **kw)
    monkeypatch.setattr(stream_resident, "recalibrate_arrays_windowed", spy)
    want = run_pipeline(a, RecalConfig(**CFG), device="cpu")
    assert seen == []
    monkeypatch.setattr(rec, "fits_resident", lambda arrays, dev: False)
    assert np.array_equal(run_pipeline(a, RecalConfig(**CFG), device="cpu"),
                          want)
    assert seen == [0]
    assert rec.RESIDENT_BYTES_PER_BASE == pytest.approx(
        3_327_267_328 / (1_533_333 * 150), abs=0.005)


def test_checkpoint_object_round_trip(tmp_path):
    from kbbq_tpu_torch.oracle.covariate import CovariateTables
    ck = tck.Checkpoint(str(tmp_path / "c"))
    assert ck.load_meta() == {"passes_done": []}
    assert ck.load_array("rows_a") is None and ck.load_covariates() is None
    rows = np.arange(64, dtype=np.uint32) * np.uint32(0x9E3779B1)
    ck.save_array("rows_a", rows)
    assert np.array_equal(ck.load_array("rows_a"), rows)
    t = CovariateTables(2, 7)
    t.cyc_errors[1, 3, 5] = 11
    ck.save_covariates(t)
    back = ck.load_covariates()
    assert (back.num_rg, back.max_len) == (2, 7)
    assert np.array_equal(back.cyc_errors, t.cyc_errors)
    j = jck.Checkpoint(str(tmp_path / "c"))
    assert np.array_equal(j.load_array("rows_a"), rows)
    assert np.array_equal(j.load_covariates().cyc_errors, t.cyc_errors)
    ck.check_fingerprint({"k": 16})
    with pytest.raises(ValueError, match="mismatched: k"):
        ck.check_fingerprint({"k": 17})

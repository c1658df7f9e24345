"""The container-windowed CRAM route of the port (io/cram_vec.py,
pipeline/cram_stream.py) against the JAX package on the same files, made
from a seed: the wholesale slice decode and scan with every condition that
sends a slice to the per-record decoder, the scan, the windows, and the
streamed files for several of the JAX package's window sizes with the host
cache on, off and overflowing; containers without a primary record, the
re-encoded fallback containers, checkpoints both ways, reports and the
set_oq refusal.  A re-encoded container holds gzip blocks, so both writes
run under one pinned clock.  On the CPU (the kernels' plain versions).
Tolerance: exact equality.
"""

import json
import time

import numpy as np
import pytest

from kbbq_tpu.io import bam as jbam
from kbbq_tpu.io import cram as jcram
from kbbq_tpu.io import cram_vec as jvec
from kbbq_tpu.io.cram_codecs import write_itf8
from kbbq_tpu.io.cram_write import write_cram as j_write_cram
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline import cram_stream as jstream

from kbbq_tpu_torch.io import cram as tcram
from kbbq_tpu_torch.io import cram_vec as tvec
from kbbq_tpu_torch.pipeline import (RecalConfig,
                                     recalibrate_cram_stream_resident)
from kbbq_tpu_torch.pipeline import cram_stream as tstream
from kbbq_tpu_torch.pipeline import stream_resident

from test_cram import _mixed_records, _ref_records

CFG = dict(k=17, coverage=20.0, batch_size=64)
CLOCK = 1.7e9


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    """One clock for every gzip block written in a test."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)


def _secondary(rec):
    rec.flag |= 0x100
    rec.data[14:16] = rec.flag.to_bytes(2, "little")


def _records(kind):
    """(BamFile, write_cram keywords, fasta bytes or None) of an input."""
    if kind in ("ref", "embref"):
        bf, ref_bytes = _ref_records(seed=41)
        return bf, dict(ref={"chr1": ref_bytes}, records_per_container=16,
                        embed_ref=kind == "embref"), ref_bytes
    if kind == "multi_slice":
        return _mixed_records(seed=31, n=300), dict(
            records_per_container=64, records_per_slice=24), None
    bf = _mixed_records(seed=37, n=100)
    kw = dict(records_per_container=20)
    conts = {"noprim_first": [0], "noprim_middle": [2], "noprim_last": [4],
             "noprim_all": range(5), "fallback": []}[kind]
    for c in conts:
        for rec in bf.records[20 * c:20 * c + 20]:
            _secondary(rec)
    if kind == "fallback":
        # a secondary record longer than every primary one: its container
        # goes down the per-record decoder and is re-encoded
        rng = np.random.default_rng(2)
        rec = jbam.build_record(
            "long", rng.integers(0, 4, 120).astype(np.int8),
            rng.integers(2, 40, 120).astype(np.uint8), flag=0x100, refid=0,
            pos=5, aux_extra=b"OQZ" + b"I" * 120 + b"\x00")
        rec._rg_index = 1
        bf.records.insert(45, rec)
    return bf, kw, None


KINDS = ["multi_slice", "noprim_first", "noprim_middle", "noprim_last",
         "noprim_all", "fallback", "ref", "embref"]


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_cram_stream")


@pytest.fixture(scope="module")
def files(d):
    """kind -> (cram path, fasta path or None)."""
    out = {}
    for kind in KINDS:
        bf, kw, ref_bytes = _records(kind)
        p = d / f"{kind}.cram"
        j_write_cram(bf, str(p), **kw)
        fa = None
        if ref_bytes is not None:
            fa = d / f"{kind}.fa"
            fa.write_text(">chr1\n" + ref_bytes.decode() + "\n")
        out[kind] = (str(p), None if fa is None else str(fa))
    return out


def _streamed(d, files, kind, side, window=None, use_oq=False, **kw):
    """The bytes of one streamed run (side "t": the port, "j": the JAX
    package at `window` reads a window)."""
    src, fa = files[kind]
    out = d / f"{side}_{kind}_{window}_{use_oq}_{sorted(kw)}.cram"
    fasta = fa if kind == "ref" else None
    if side == "t":
        info = recalibrate_cram_stream_resident(
            src, str(out), RecalConfig(**CFG), use_oq=use_oq,
            fasta_ref=fasta, device="cpu", **kw)
    else:
        info = jstream.recalibrate_cram_stream_resident(
            src, str(out), JRecalConfig(**CFG), use_oq=use_oq,
            fasta_ref=fasta, window_reads=window, **kw)
    return out.read_bytes(), info


@pytest.fixture(scope="module")
def jax_bytes(d, files):
    """kind -> the JAX package's streamed bytes (window of 32 reads)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(time, "time", lambda: CLOCK)
    try:
        return {kind: _streamed(d, files, kind, "j", 32)[0]
                for kind in KINDS}
    finally:
        mp.undo()


# ------------------------------------------------------------ slice decode

def test_itf8_stream_decode_equals_the_jax_packages():
    rng = np.random.default_rng(3)
    vals = [int(v) for v in rng.integers(0, 2 ** 32, 700)]
    vals += [0, 1, 127, 128, 16383, 16384, 2 ** 28 - 1, 2 ** 31 - 1]
    data = b"".join(write_itf8(v) for v in vals)
    for count in (0, 1, 5, len(vals)):
        got, end = tvec.itf8_decode_stream(data, count)
        want, wend = jvec.itf8_decode_stream(data, count)
        assert np.array_equal(got, want) and end == wend
    with pytest.raises(tcram.CRAMError, match="truncated"):
        tvec.itf8_decode_stream(data[:3], 4)


def _slices(path):
    with jcram.CramStream(path) as cs:
        names, refs = cs.rg_names, cs.ref_names
        groups = [(cont, jcram.parse_compression_header(blocks[0].data), g)
                  for cont, blocks, _ in cs.containers()
                  for g in jcram.split_slices(blocks)]
    registry = {nm: i for i, nm in enumerate(names)}
    lut = np.zeros(len(names) + 1, np.int32)
    for i, nm in enumerate(names):
        lut[i + 1] = registry[nm]
    return groups, refs, lut


def _same(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    for g, w in zip(got[:7], want[:7]):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    for f in ("qs_cid", "qs_len", "offs", "lens", "rev"):
        assert np.array_equal(getattr(got[7], f), getattr(want[7], f)), f


def _mutate(comp, how):
    """A compression header the wholesale decoder must refuse."""
    if how == "shared_cid":
        comp.ds["MQ"] = comp.ds["RL"]
    elif how == "core_bits":
        comp.ds["BF"] = (6, write_itf8(0) + write_itf8(12))      # BETA
    elif how == "bb_not_stop":
        comp.ds["BB"] = comp.ds["QS"]
    elif how == "qs_shared":
        comp.ds["BA"] = comp.ds["QS"]


@pytest.mark.parametrize("kind,how,use_oq,short", [
    ("multi_slice", None, False, 0), ("multi_slice", None, True, 0),
    ("ref", None, False, 0), ("embref", None, False, 0),
    ("fallback", None, False, 0), ("multi_slice", None, False, 1),
    ("multi_slice", "shared_cid", False, 0),
    ("multi_slice", "core_bits", False, 0),
    ("multi_slice", "bb_not_stop", False, 0),
    ("multi_slice", "qs_shared", False, 0)])
def test_slice_decode_and_scan_equal_the_jax_packages(files, kind, how,
                                                      use_oq, short):
    """decode_slice_vec and scan_slice_vec on every slice: the JAX
    package's arrays, or None where it falls back (shared content ids,
    core-bit codecs, a record longer than max_len, ...)."""
    from kbbq_tpu_torch.io.fasta import read_fasta
    path, fa = files[kind]
    fasta = fa if kind == "ref" else None
    refs = read_fasta(fasta) if fasta else None
    # the longest primary record of the file, as the streamed route's scan
    max_len = jstream.scan_cram(path, 17, fasta)[3] - short
    groups, ref_names, lut = _slices(path)
    fallbacks = 0
    for cont, comp, group in groups:
        if how is not None:
            _mutate(comp, how)
        want = jvec.decode_slice_vec(comp, group, refs, ref_names, max_len,
                                     lut, use_oq)
        got = tvec.decode_slice_vec(comp, group, refs, ref_names, max_len,
                                    lut, use_oq)
        _same(got, want)
        fallbacks += want is None
        ws, gs = jvec.scan_slice_vec(comp, group), \
            tvec.scan_slice_vec(comp, group)
        assert (ws is None) == (gs is None)
        if ws is not None:
            for g, w in zip(gs, ws):
                assert np.array_equal(g, w)
    if how is not None:
        assert fallbacks == len(groups)
    elif short:                  # the slices that hold a longest record
        assert 0 < fallbacks < len(groups)
    else:
        assert fallbacks == (kind == "fallback")


@pytest.mark.parametrize("kind", ["multi_slice", "fallback", "ref",
                                  "noprim_all"])
def test_scan_equals_the_jax_packages(files, kind):
    path, fa = files[kind]
    fasta = fa if kind == "ref" else None
    got = tstream.scan_cram_meta(path, 17, fasta)
    want = jstream.scan_cram_meta(path, 17, fasta)
    assert got == want
    assert tstream.scan_cram(path, 17, fasta) == want[1:]


def test_slow_arrays_equal_the_jax_packages(files):
    path, _ = files["fallback"]
    groups, ref_names, _ = _slices(path)
    names = ["g0", "g1"]
    registry = {"g1": 0, "g0": 1}
    for cont, comp, group in groups:
        recs = jcram.decode_slice(comp, group, cont.ref_id, None, ref_names)
        trecs = tcram.decode_slice(comp, group, cont.ref_id, None, ref_names)
        for use_oq in (False, True):
            for g, w in zip(tstream._slow_arrays(trecs, 120, registry, names,
                                                 use_oq),
                            jstream._slow_arrays(recs, 120, registry, names,
                                                 use_oq)):
                assert np.array_equal(g, w)


# ------------------------------------------------------------------ windows

@pytest.mark.parametrize("kind", ["multi_slice", "noprim_first",
                                  "noprim_middle", "noprim_last",
                                  "noprim_all", "fallback"])
def test_one_window_per_container_with_a_primary(files, kind):
    path, _ = files[kind]
    metas, n, bases, tk, max_len, registry, names, _ = \
        tstream.scan_cram_meta(path, 17, None)
    src = tstream.CramWindowSource(path, None, registry, names, max_len, n,
                                   bases, tk, False)
    seen, conts = [], 0
    for ordinal, arrays, items in src.windows():
        seen.append(ordinal)
        assert arrays[0].shape == (sum(sum(it[4]) for it in items), max_len)
        conts += len(items)
    with_prim = [m["ordinal"] for m in metas if m["n_primary"]]
    assert seen == with_prim
    assert conts == (len(metas) if with_prim else 0)


# ------------------------------------------------------------ streamed files

@pytest.mark.parametrize("kind", KINDS)
def test_streamed_route_writes_the_jax_packages_bytes(d, files, jax_bytes,
                                                      kind):
    got, info = _streamed(d, files, kind, "t")
    assert got == jax_bytes[kind]
    assert info["format"] == "cram" and info["streamed"]


@pytest.mark.parametrize("window", [7, 96, 100000])
def test_jax_bytes_do_not_depend_on_its_window(d, files, jax_bytes, window):
    got = _streamed(d, files, "multi_slice", "t",
                    host_cache_bytes=0 if window == 7 else 5000)[0]
    assert got == _streamed(d, files, "multi_slice", "j", window)[0] == \
        jax_bytes["multi_slice"]


@pytest.mark.parametrize("caches", ["host_off", "host_overflow",
                                    "device_off", "both_off"])
@pytest.mark.parametrize("kind", ["multi_slice", "fallback"])
def test_caches_change_no_byte(d, files, jax_bytes, caches, kind):
    kw = {"host_off": dict(host_cache_bytes=0),
          "host_overflow": dict(host_cache_bytes=20000),
          "device_off": dict(device_cache_bytes=0),
          "both_off": dict(host_cache_bytes=0,
                           device_cache_bytes=0)}[caches]
    assert _streamed(d, files, kind, "t", **kw)[0] == jax_bytes[kind]


@pytest.mark.parametrize("kind", ["multi_slice", "fallback"])
def test_use_oq_equals_the_jax_packages(d, files, kind):
    assert _streamed(d, files, kind, "t", use_oq=True)[0] == \
        _streamed(d, files, kind, "j", 40, use_oq=True)[0]


def test_non_qs_blocks_keep_their_bytes(d, files, jax_bytes):
    out = d / "surgery.cram"
    out.write_bytes(jax_bytes["multi_slice"])
    with tcram.CramStream(files["multi_slice"][0]) as a, \
            tcram.CramStream(str(out)) as b:
        changed = kept = 0
        for (ca, ba, ra), (cb, bb, rb) in zip(a.containers(), b.containers(),
                                              strict=True):
            for x, y in zip(ba, bb, strict=True):
                sx = ra[ca.body_pos:][x.span[0]:x.span[1]]
                sy = rb[cb.body_pos:][y.span[0]:y.span[1]]
                if x.content_type == tcram.CT_EXTERNAL and \
                        x.content_id == 14:
                    changed += x.data != y.data
                else:
                    assert sx == sy
                    kept += 1
    assert changed and kept


def test_set_oq_is_refused(d, files):
    with pytest.raises(ValueError, match="set-oq"):
        recalibrate_cram_stream_resident(files["multi_slice"][0],
                                         str(d / "never.cram"),
                                         RecalConfig(**CFG), set_oq=True,
                                         device="cpu")
    assert not (d / "never.cram").exists()


# ----------------------------------------------------- checkpoints, reports

def test_checkpoints_resume_both_ways_and_refuse_another_k(d, files,
                                                           jax_bytes,
                                                           monkeypatch):
    src = files["multi_slice"][0]
    jck, tck = d / "j_ck", d / "t_ck"
    jstream.recalibrate_cram_stream_resident(
        src, str(d / "j_ck.cram"), JRecalConfig(**CFG), window_reads=50,
        checkpoint_dir=str(jck))
    recalibrate_cram_stream_resident(src, str(d / "t_ck.cram"),
                                     RecalConfig(**CFG),
                                     checkpoint_dir=str(tck), device="cpu")
    t_meta = json.loads((tck / "meta.json").read_text())
    assert t_meta == json.loads((jck / "meta.json").read_text())
    assert t_meta["fingerprint"]["cram"] is True
    for f in ("rows_a.npy", "rows_b.npy", "cov_cyc_total.npy",
              "cov_din_errors.npy"):
        assert np.array_equal(np.load(tck / f), np.load(jck / f))
    # the port resumes the JAX package's directory without running a pass
    for name in ("run_pass1", "run_pass2", "run_pass3"):
        monkeypatch.setattr(stream_resident.StreamResidentEngine, name,
                            lambda self: pytest.fail("a pass ran"))
    out = d / "resumed.cram"
    recalibrate_cram_stream_resident(src, str(out), RecalConfig(**CFG),
                                     checkpoint_dir=str(jck), device="cpu")
    assert out.read_bytes() == jax_bytes["multi_slice"]
    # and the JAX package resumes the port's
    jout = d / "j_resumed.cram"
    jstream.recalibrate_cram_stream_resident(
        src, str(jout), JRecalConfig(**CFG), window_reads=50,
        checkpoint_dir=str(tck))
    assert jout.read_bytes() == jax_bytes["multi_slice"]
    with pytest.raises(ValueError, match="different parameters"):
        recalibrate_cram_stream_resident(src, str(out),
                                         RecalConfig(**dict(CFG, k=15)),
                                         checkpoint_dir=str(tck),
                                         device="cpu")


def test_report_out_and_apply_report(d, files, jax_bytes):
    src = files["fallback"][0]
    r_t, r_j = d / "t.report", d / "j.report"
    _, _ = _streamed(d, files, "fallback", "t", report_out=str(r_t))
    jstream.recalibrate_cram_stream_resident(
        src, str(d / "j_rep.cram"), JRecalConfig(**CFG), window_reads=32,
        report_out=str(r_j))
    assert r_t.read_bytes() == r_j.read_bytes()
    got = _streamed(d, files, "fallback", "t", apply_report=str(r_j))[0]
    assert got == jax_bytes["fallback"]


def test_timings_name_every_stage(d, files):
    t: dict = {}
    _streamed(d, files, "multi_slice", "t", timings=t)
    for stage in ("scan", "setup", "pass1", "pass2", "pass3", "deltas",
                  "pass4"):
        assert stage in t

"""BAM in the port (io/bam.py, io/bam_vec.py, io/bam_stream.py,
pipeline/bam.py, pipeline/stream_resident.py) against the JAX package on
the same bytes, made from a seed: the record codec, the whole-chunk decode,
scan and rewrite, and the files both routes write, with read groups,
reverse-strand, untagged, empty and pass-through records, --use-oq and
--set-oq, checkpoints and reports.  On the CPU (the kernels' plain
versions).  Tolerance: exact equality.
"""

import gzip
import json
import os
import struct

import numpy as np
import pytest

from kbbq_tpu.io import bam as jbam
from kbbq_tpu.io import bam_stream as jstream
from kbbq_tpu.io import bam_vec as jvec
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline.bam import recalibrate_bam as j_recalibrate_bam
from kbbq_tpu.pipeline.bam import (
    recalibrate_bam_streaming as j_recalibrate_bam_streaming)
from kbbq_tpu.utils.synth import make_dataset

from kbbq_tpu_torch.io import bam as tbam
from kbbq_tpu_torch.io import bam_stream as tstream
from kbbq_tpu_torch.io import bam_vec as tvec
from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_bam,
                                     recalibrate_bam_streaming,
                                     recalibrate_fastq)
from kbbq_tpu_torch.pipeline import stream_resident

CFG = dict(k=16, coverage=20.0, batch_size=64)
HEADER = ("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1400\n"
          "@RG\tID:rg3\n@RG\tID:rg1\n@RG\tID:rg2\n")
REFS = [("chr1", 1400)]
RC = np.array([3, 2, 1, 0, 4], np.int8)


def bam_records(seed=5, oq="none", odd=None, rg=True, extra=True):
    """Records of the JAX package's codec from make_dataset reads: lengths
    44 and 45 (odd), half reverse strand (stored reverse-complemented),
    read groups "rg2", "rg1", "rg3" and untagged ones (first appearance
    order differs from the header's), CIGARs, aux types A / i / B / H /
    f, one QUAL of 0xff; then secondary and supplementary copies and
    l_seq == 0 records between them.  oq: "none", "all" (an OQ tag on
    every record, before the other aux tags) or "some".  odd: None,
    "unterminated" (a last Z value without its NUL on some records: the
    per-record route, which parses it) or "unknown" (an aux type Q on an
    untagged record, so the walk reaches it: the per-record route
    raises)."""
    ds = make_dataset(genome_len=1400, read_len=45, coverage=16.0,
                      error_rate=0.02, seed=seed, paired=True, n_rate=0.005)
    rng = np.random.default_rng(seed)
    recs = []
    for i, (c, q) in enumerate(zip(ds.codes, ds.quals)):
        L = 45 - (i % 3 == 0)
        c = np.asarray(c)[:L].astype(np.int8)
        q = np.asarray(q)[:L].astype(np.uint8)
        if i == 7:
            q = np.full(L, 0xFF, np.uint8)           # QUAL "*"
        flag = 0x1 | (0x80 if ds.seconds[i] else 0x40)
        if rng.random() < 0.5:
            flag |= 0x10
            c, q = RC[c][::-1], q[::-1]
        aux = b""
        if oq == "all" or (oq == "some" and i % 4 == 1):
            aux += b"OQZ" + bytes(((q.astype(np.int64) * 7 + i) % 60
                                   + 33).astype(np.uint8)) + b"\x00"
        aux += [b"NMi" + struct.pack("<i", i % 5), b"XAAx",
                b"XBBC" + struct.pack("<I", 3) + bytes([1, 2, 3]),
                b"XHHBEEF\x00", b"XFf" + struct.pack("<f", 0.5)][i % 5]
        if odd == "unterminated" and i % 11 == 3:
            aux += b"XZZabc"
        if odd == "unknown" and i == 90:          # an untagged record
            aux += b"XQQ\x01"
        name = ["rg2", "rg1", None, "rg3"][(i // 40) % 4] if rg else None
        cigar = [("S", 2), ("M", L - 2)] if i % 2 else [("M", L)]
        rec = jbam.build_record(f"r{i}", c, q, flag=flag, rg=name, refid=0,
                                pos=3 * i, cigar=cigar, aux_extra=aux)
        recs.append(rec)
        if extra and i % 13 == 4:
            recs.append(jbam.build_record(
                f"r{i}", c, q, flag=flag | (0x100 if i % 2 else 0x800),
                rg=name, refid=0, pos=3 * i, cigar=cigar, aux_extra=aux))
        if extra and i % 29 == 8:
            recs.append(jbam.build_record(f"e{i}", np.zeros(0, np.int8),
                                          np.zeros(0, np.uint8), flag=0x4,
                                          rg=name))
    return jbam.BamFile(HEADER, REFS, recs)


def write_bam(path, bf, how="bgzf"):
    raw = jbam.serialize_bam(bf, compress=False)
    data = {"bgzf": lambda: jbam.serialize_bam(bf), "raw": lambda: raw,
            "gzip": lambda: gzip.compress(raw)}[how]()
    path.write_bytes(data)
    return str(path)


def raw_chunk(bf):
    """(buf, offs, sizes) of all the records, the JAX package's index."""
    return jbam.parse_bam_bytes_indexed(jbam.serialize_bam(bf,
                                                           compress=False))[1:]


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_bam")


@pytest.fixture(scope="module")
def inputs(d):
    return {"plain": write_bam(d / "plain.bam", bam_records()),
            "oq": write_bam(d / "oq.bam", bam_records(oq="all")),
            "odd": write_bam(d / "odd.bam", bam_records(odd="unterminated")),
            "gzip": write_bam(d / "gz.bam", bam_records(), "gzip")}


@pytest.fixture(scope="module")
def jax_files(d, inputs):
    """The JAX package's whole-file outputs: (input, use_oq, set_oq) ->
    bytes."""
    out = {}
    for name, use_oq, set_oq in (("plain", False, False),
                                 ("plain", False, True),
                                 ("oq", True, True), ("oq", False, True),
                                 ("odd", False, True)):
        p = d / f"j_{name}_{use_oq}_{set_oq}.bam"
        j_recalibrate_bam(inputs[name], str(p), JRecalConfig(**CFG),
                          use_oq=use_oq, set_oq=set_oq)
        out[name, use_oq, set_oq] = p.read_bytes()
    return out


# ----------------------------------------------------------------- codec

@pytest.mark.parametrize("kw", [
    dict(),
    dict(oq="all"),
    dict(odd="unterminated", rg=False),
])
def test_codec_gives_the_jax_packages_bytes(d, kw):
    """build_record / serialize_bam / parse in the port: the JAX package's
    bytes, records and machine-order reads."""
    bf = bam_records(**kw)
    mine = tbam.BamFile(bf.header_text, bf.refs, [
        tbam.build_record(r.name, r.seq_codes(), r.quals().astype(np.uint8),
                          flag=r.flag, refid=r.refid, pos=r.pos,
                          cigar=_cigar(r), aux_extra=bytes(r.data[r.aux_off:]))
        for r in bf.records])
    for how in (False, True):
        assert tbam.serialize_bam(mine, compress=how) == \
            jbam.serialize_bam(bf, compress=how)
    raw = jbam.serialize_bam(bf, compress=False)
    got = tbam.parse_bam_bytes(raw)
    assert got.header_text == bf.header_text and got.refs == bf.refs
    for a, b in zip(got.records, bf.records):
        assert bytes(a.data) == bytes(b.data)
        assert (a.name, a.flag, a.l_seq, a.seq_off, a.qual_off, a.aux_off,
                a.refid, a.pos) == (b.name, b.flag, b.l_seq, b.seq_off,
                                    b.qual_off, b.aux_off, b.refid, b.pos)
        assert a.aux_tags() == b.aux_tags()
        for use_oq in (False, True):
            if use_oq and b.get_zstr("OQ") is None:
                continue
            for x, y in zip(tbam.machine_order_read(a, use_oq),
                            jbam.machine_order_read(b, use_oq)):
                assert np.array_equal(x, y) and x.dtype == y.dtype
    for how in ("bgzf", "gzip", "raw"):
        p = write_bam(d / f"codec_{how}.bam", bf, how)
        assert tbam.serialize_bam(tbam.read_bam(p), compress=False) == raw


def _cigar(rec):
    ops = "MIDNSHP=X"
    n = struct.unpack_from("<H", rec.data, 12)[0]
    at = 32 + rec.data[8]
    return [(ops[v & 0xF], v >> 4) for v in
            struct.unpack_from(f"<{n}I", rec.data, at)]


@pytest.mark.parametrize("set_oq", [False, True])
def test_rewrite_quals_and_set_zstr_tag_match(set_oq):
    """The per-record rewrite (reverse strand, an existing OQ replaced at
    the end, QUAL 0xff wrapping to 0x20 in OQ) gives the JAX bytes."""
    bf = bam_records(oq="some")
    rng = np.random.default_rng(2)
    for rec in bf.records[:60]:
        a = tbam.record_from_body(bytearray(rec.data))
        b = jbam.record_from_body(bytearray(rec.data))
        q = rng.integers(2, 41, rec.l_seq).astype(np.int8)
        tbam.rewrite_quals(a, q, set_oq=set_oq)
        jbam.rewrite_quals(b, q, set_oq=set_oq)
        assert a.data == b.data


def test_header_and_errors():
    raw = jbam.serialize_bam(bam_records(), compress=False)
    assert tbam.parse_bam_header(raw) == jbam.parse_bam_header(raw)
    assert tbam.bam_header_bytes(HEADER, REFS) == raw[:tbam.parse_bam_header(
        raw)[2]]
    with pytest.raises(tbam.BAMError, match="magic"):
        tbam.parse_bam_bytes(b"BAX\x01" + raw[4:])
    with pytest.raises(tbam.BAMError, match="truncated"):
        tbam.parse_bam_bytes(raw[:-3])


# ------------------------------------------------------- chunk functions

@pytest.mark.parametrize("use_oq", [False, True])
@pytest.mark.parametrize("oq", ["none", "all", "some"])
@pytest.mark.parametrize("odd", [None, "unterminated"])
def test_decode_and_scan_chunk_match(use_oq, oq, odd):
    """decode_machine_chunk and scan_chunk = the JAX package's, or the same
    BAMError (use_oq on a record without OQ)."""
    buf, offs, sizes = raw_chunk(bam_records(oq=oq, odd=odd))
    scan = tvec.scan_chunk(buf, offs, sizes, 16)
    assert scan == jvec.scan_chunk(buf, offs, sizes, 16)
    registry = {k: i for i, k in enumerate(scan[4])}
    assert "" in registry and list(registry)[:3] == ["rg2", "rg1", ""]
    args = (buf, offs, sizes, scan[3], registry)
    try:
        want = jvec.decode_machine_chunk(*args, use_oq=use_oq)
    except jbam.BAMError as e:
        with pytest.raises(tbam.BAMError, match=f"^{str(e)}$"):
            tvec.decode_machine_chunk(*args, use_oq=use_oq)
        assert oq != "all"
        return
    got = tvec.decode_machine_chunk(*args, use_oq=use_oq)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    if not use_oq:
        assert (got[1][got[2]] == 93).any()  # QUAL 0xff clips to 93


@pytest.mark.parametrize("set_oq", [False, True])
@pytest.mark.parametrize("oq", ["none", "all", "some"])
@pytest.mark.parametrize("odd", [None, "unterminated"])
def test_rewrite_quals_chunk_matches(set_oq, oq, odd):
    """Both set_oq paths (every record grows by the same rule; or records
    one by one, deleting an existing OQ), the per-record route of odd
    records, pass-through records: the JAX package's bytes."""
    buf, offs, sizes = raw_chunk(bam_records(oq=oq, odd=odd))
    _, _, _, max_len, keys = jvec.scan_chunk(buf, offs, sizes, 16)
    dec = jvec.decode_machine_chunk(buf, offs, sizes, max_len,
                                    {k: i for i, k in enumerate(keys)})
    lens, prim = dec[5], dec[6]
    new_q = np.random.default_rng(3).integers(
        2, 41, (prim.size, max_len)).astype(np.int8)
    got = tvec.rewrite_quals_chunk(buf, offs, sizes, prim, lens, new_q,
                                   set_oq=set_oq)
    want = jvec.rewrite_quals_chunk(buf, offs, sizes, prim, lens, new_q,
                                    set_oq=set_oq)
    assert bytes(got) == bytes(want)


def test_unknown_aux_type_raises_the_per_record_message():
    buf, offs, sizes = raw_chunk(bam_records(odd="unknown"))
    registry = {"rg2": 0, "rg1": 1, "": 2, "rg3": 3}
    for fn, args in (("scan_chunk", (16,)),
                     ("decode_machine_chunk", (45, registry))):
        with pytest.raises(jbam.BAMError) as want:
            getattr(jvec, fn)(buf, offs, sizes, *args)
        with pytest.raises(tbam.BAMError, match=f"^{str(want.value)}$"):
            getattr(tvec, fn)(buf, offs, sizes, *args)
    assert str(want.value) == "unknown aux type Q in r90"
    prim = tvec.primary_rows(tvec.bam_fields(buf, offs)["flag"],
                             tvec.bam_fields(buf, offs)["l_seq"])
    q = np.full((prim.size, 45), 20, np.int8)
    lens = tvec.bam_fields(buf, offs)["l_seq"][prim]
    with pytest.raises(jbam.BAMError) as want:
        jvec.rewrite_quals_chunk(buf, offs, sizes, prim, lens, q, True)
    with pytest.raises(tbam.BAMError, match=f"^{str(want.value)}$"):
        tvec.rewrite_quals_chunk(buf, offs, sizes, prim, lens, q, True)


def test_many_read_groups_match():
    """More read-group names than the compares split off before sorting:
    scan_chunk's order of first appearance and decode's ids = JAX's."""
    recs = [jbam.build_record(f"r{i}", np.full(30, i % 4, np.int8),
                              np.full(30, 20 + i % 9, np.uint8), flag=0,
                              rg=None if i % 23 == 5 else f"g{(i * 7) % 40}")
            for i in range(200)]
    buf, offs, sizes = raw_chunk(jbam.BamFile(HEADER, REFS, recs))
    scan = tvec.scan_chunk(buf, offs, sizes, 8)
    assert scan == jvec.scan_chunk(buf, offs, sizes, 8) and len(scan[4]) == 41
    registry = {k: i for i, k in enumerate(scan[4])}
    for g, w in zip(tvec.decode_machine_chunk(buf, offs, sizes, 30, registry),
                    jvec.decode_machine_chunk(buf, offs, sizes, 30, registry)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("oq", [False, True])
def test_synthetic_bam_writer(d, oq):
    """utils/synth.py::arrays_to_bam_bytes: the JAX package reads the file
    (header, read groups in header order reversed, flags), its decode of the
    primaries gives the generator's rows back (from the OQ tags with
    use_oq), and the port's decode equals it."""
    from kbbq_tpu_torch.utils.synth import (BAM_READ_GROUPS,
                                            arrays_to_bam_bytes,
                                            make_arrays_fast, read_starts)
    a, _ = make_arrays_fast(genome_len=3000, read_len=51, num_reads=900,
                            seed=4)
    oq_quals = ((a.quals.astype(np.int64) * 3) % 41).astype(np.int8)
    data, rows = arrays_to_bam_bytes(a, read_starts(3000, 51, 900, 4),
                                     extra_share=0.05,
                                     oq_quals=oq_quals if oq else None)
    p = d / f"synth_{oq}.bam"
    p.write_bytes(data)
    bf = jbam.read_bam(str(p))
    hdr = [ln.split("\t")[1][3:] for ln in bf.header_text.splitlines()
           if ln.startswith("@RG")]
    assert hdr == list(BAM_READ_GROUPS)[::-1]
    assert "SO:coordinate" in bf.header_text
    pos = [r.pos for r in bf.records]
    assert pos == sorted(pos)
    flags = np.array([r.flag for r in bf.records])
    extra = (flags & 0x900) != 0
    assert 0.02 < extra.mean() < 0.09 and 0.4 < (flags & 0x10).mean() / 16 \
        < 0.6
    buf, offs, sizes = raw_chunk(bf)
    scan = jvec.scan_chunk(buf, offs, sizes, 16)
    assert scan[4] == list(BAM_READ_GROUPS) and scan[0] == 900
    registry = {k: i for i, k in enumerate(scan[4])}
    want = jvec.decode_machine_chunk(buf, offs, sizes, 51, registry,
                                     use_oq=oq)
    got = tvec.decode_machine_chunk(buf, offs, sizes, 51, registry,
                                    use_oq=oq)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(got[0], a.codes[rows])
    assert np.array_equal(got[1], (oq_quals if oq else a.quals)[rows])
    assert np.array_equal(got[4], a.seconds[rows])
    assert np.array_equal(got[3], np.arange(900) % 3)


@pytest.mark.parametrize("chunk_records", [1, 37, 1000])
def test_raw_chunks_equal_the_jax_packages(inputs, chunk_records):
    """iter_bam_raw_chunks: the same header and chunks as the JAX
    package's; the plain record index gives the native one's result."""
    th, tr, tchunks = tstream.iter_bam_raw_chunks(inputs["plain"],
                                                  chunk_records)
    jh, jr, jchunks = jstream.iter_bam_raw_chunks(inputs["plain"],
                                                  chunk_records)
    assert (th, tr) == (jh, jr)
    n = 0
    for (tb, to, ts), (jb, jo, js) in zip(tchunks, jchunks, strict=True):
        assert np.array_equal(tb, jb) and np.array_equal(to, jo) and \
            np.array_equal(ts, js)
        for a, b in zip(tstream._scan_record_index_plain(tb, 0),
                        tstream._scan_record_index(tb, 0)):
            assert np.array_equal(a, b)
        n += to.size
    assert n == len(bam_records().records)


def test_truncated_stream_and_plain_gzip_refused_by_the_stream(d, inputs):
    raw = jbam.serialize_bam(bam_records(), compress=False)
    p = d / "cut.bam"
    p.write_bytes(jbam.bgzf.compress(raw[:-5]))
    with pytest.raises(tbam.BAMError, match="truncated"):
        list(tstream.iter_bam_raw_chunks(str(p))[2])
    with pytest.raises(ValueError, match="BGZF"):
        tstream.iter_bam_raw_chunks(inputs["gzip"])


# ----------------------------------------------------------------- files

@pytest.mark.parametrize("name,use_oq,set_oq", [
    ("plain", False, False), ("plain", False, True), ("oq", True, True),
    ("oq", False, True), ("odd", False, True)])
def test_whole_file_route_writes_the_jax_packages_bytes(d, inputs, jax_files,
                                                        name, use_oq,
                                                        set_oq):
    out = d / f"t_{name}_{use_oq}_{set_oq}.bam"
    info = recalibrate_bam(inputs[name], str(out), RecalConfig(**CFG),
                           use_oq=use_oq, set_oq=set_oq, device="cpu")
    assert out.read_bytes() == jax_files[name, use_oq, set_oq]
    assert info["read_groups"] == 4


def test_plain_gzip_bam_input(d, inputs, jax_files):
    out = d / "t_gz.bam"
    recalibrate_bam(inputs["gzip"], str(out), RecalConfig(**CFG),
                    device="cpu")
    assert out.read_bytes() == jax_files["plain", False, False]


@pytest.mark.parametrize("sink", ["sam", "writable"])
def test_bam_to_sam_and_unnamed_sinks(d, inputs, sink):
    """A .sam output of a BAM input, and a writable (the input's format):
    the JAX package's bytes."""
    cfg = dict(use_oq=False, set_oq=True)
    if sink == "sam":
        o1, o2 = d / "t.sam", d / "j.sam"
        recalibrate_bam(inputs["odd"], str(o1), RecalConfig(**CFG),
                        device="cpu", **cfg)
        j_recalibrate_bam(inputs["odd"], str(o2), JRecalConfig(**CFG), **cfg)
        assert o1.read_bytes() == o2.read_bytes()
        assert o1.read_bytes().startswith(b"@HD")
        return
    import io
    t, j = io.BytesIO(), io.BytesIO()
    recalibrate_bam(inputs["odd"], t, RecalConfig(**CFG), device="cpu",
                    **cfg)
    j_recalibrate_bam(inputs["odd"], j, JRecalConfig(**CFG), **cfg)
    assert t.getvalue() == j.getvalue() and t.getvalue()[:2] == b"\x1f\x8b"


def test_cram_output_and_devices_are_refused(d, inputs, monkeypatch):
    """The whole-file route writes a .cram output as the JAX package does
    (its gzip blocks stamp the clock: both writes run under one pinned
    clock); the streamed route refuses .cram and .sam names, and on
    several devices more devices than there are; the hash-space-sharded
    layout on two ranks writes one device's bytes."""
    import time
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    for name, kw in (("plain", dict(set_oq=True)),
                     ("oq", dict(use_oq=True))):
        t, j = d / f"t_{name}.cram", d / f"j_{name}.cram"
        recalibrate_bam(inputs[name], str(t), RecalConfig(**CFG),
                        device="cpu", **kw)
        j_recalibrate_bam(inputs[name], str(j), JRecalConfig(**CFG), **kw)
        assert t.read_bytes() == j.read_bytes()
        assert t.read_bytes()[:4] == b"CRAM"
    with pytest.raises(ValueError, match="writes BAM"):
        recalibrate_bam_streaming(inputs["plain"], str(d / "x.cram"),
                                  RecalConfig(**CFG), device="cpu")
    for name, kw in (("one", {}), ("sharded", dict(
            devices=2, bloom_layout="sharded"))):
        recalibrate_bam_streaming(inputs["plain"], str(d / f"{name}.bam"),
                                  RecalConfig(**CFG), device="cpu", **kw)
    assert (d / "sharded.bam").read_bytes() == (d / "one.bam").read_bytes()
    with pytest.raises(ValueError, match="requested but only"):
        recalibrate_bam_streaming(inputs["plain"], str(d / "x.bam"),
                                  RecalConfig(**CFG), devices=100000,
                                  device="cpu")
    assert not os.path.exists(d / "x.bam")
    with pytest.raises(ValueError, match="writes BAM"):
        recalibrate_bam_streaming(inputs["plain"], str(d / "x.sam"),
                                  RecalConfig(**CFG), device="cpu")
    assert not os.path.exists(d / "x.cram")


# -------------------------------------------------------------- windowed

@pytest.fixture(scope="module")
def jax_streamed(d, inputs):
    """The JAX package's streamed bytes (set_oq), with a checkpoint
    directory it wrote."""
    p = d / "j_streamed.bam"
    j_recalibrate_bam_streaming(inputs["plain"], str(p), JRecalConfig(**CFG),
                                set_oq=True, chunk_records=37,
                                checkpoint_dir=str(d / "j_ck"))
    return p.read_bytes()


@pytest.mark.parametrize("chunk_records", [37, 1000])
@pytest.mark.parametrize("caches", ["on", "off"])
def test_windowed_route_writes_the_same_bytes(d, inputs, jax_files,
                                              jax_streamed, chunk_records,
                                              caches):
    out = d / f"s_{chunk_records}_{caches}.bam"
    kw = {} if caches == "on" else dict(host_cache_bytes=0,
                                        device_cache_bytes=0)
    info = recalibrate_bam_streaming(inputs["plain"], str(out),
                                     RecalConfig(**CFG), set_oq=True,
                                     chunk_records=chunk_records,
                                     device="cpu", **kw)
    assert out.read_bytes() == jax_streamed == \
        jax_files["plain", False, True]
    n = len(bam_records().records)
    assert info["windows"] == -(-n // chunk_records)


@pytest.mark.parametrize("where", ["first", "middle", "last", "all"])
def test_chunks_without_primaries_pass_through(d, where):
    """Raw chunks holding only secondary / supplementary / empty records,
    before, between and after the windows, or the whole file: written in
    place, and the rest as the whole-file route writes it."""
    bf = bam_records(extra=False)
    main = bf.records[:len(bf.records) // 6 * 6]
    head, tail = main[:150], main[150:]
    side = [jbam.build_record(f"s{i}", np.full(20, i % 4, np.int8),
                              np.full(20, 30, np.uint8),
                              flag=[0x100, 0x800][i % 2], rg="rg1")
            if i % 3 else
            jbam.build_record(f"e{i}", np.zeros(0, np.int8),
                              np.zeros(0, np.uint8), flag=0x4)
            for i in range(12)]
    recs = {"first": side + main, "middle": head + side + tail,
            "last": main + side, "all": side}[where]
    src = write_bam(d / f"pt_{where}.bam", jbam.BamFile(HEADER, REFS, recs))
    w, s = d / f"pt_{where}_w.bam", d / f"pt_{where}_s.bam"
    recalibrate_bam(src, str(w), RecalConfig(**CFG), set_oq=True,
                    device="cpu")
    recalibrate_bam_streaming(src, str(s), RecalConfig(**CFG), set_oq=True,
                              chunk_records=6, device="cpu")
    assert s.read_bytes() == w.read_bytes()
    back = tbam.read_bam(str(s)).records
    assert len(back) == len(recs)
    if where == "all":
        assert [bytes(r.data) for r in back] == [bytes(r.data) for r in recs]


def test_global_ordinals_count_primaries_across_chunks(inputs):
    """The window source's ordinals count primary records only, across
    chunks, and every raw chunk belongs to exactly one window."""
    n, bases, tk, max_len, reg = tvec_scan(inputs["plain"])
    src = stream_resident.BamWindowSource(inputs["plain"], reg, max_len, n,
                                          bases, tk, False, 37)
    ordinals, raws, rows = [], 0, 0
    for ordinal, arrs, chunks in src.windows():
        ordinals.append(ordinal)
        assert ordinal == rows
        rows += arrs[0].shape[0]
        raws += len(chunks)
    assert rows == n and raws == -(-len(bam_records().records) // 37)


def tvec_scan(path):
    from kbbq_tpu_torch.pipeline.bam import scan_bam
    from kbbq_tpu.pipeline.bam import scan_bam as j_scan_bam
    got = scan_bam(path, 16, chunk_records=37)
    assert got == j_scan_bam(path, 16, chunk_records=37)
    return got


# ----------------------------------------------------- checkpoints, reports

def test_resumes_from_a_jax_checkpoint_and_refuses_another_k(
        d, inputs, jax_streamed, monkeypatch):
    ck = d / "j_ck"
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["passes_done"] == ["rows_a", "rows_b", "covariates"]
    assert meta["fingerprint"]["bam"] is True
    for name in ("run_pass1", "run_pass2", "run_pass3"):
        monkeypatch.setattr(stream_resident.StreamResidentEngine, name,
                            lambda self: pytest.fail("a pass ran"))
    out = d / "resumed.bam"
    recalibrate_bam_streaming(inputs["plain"], str(out), RecalConfig(**CFG),
                              set_oq=True, checkpoint_dir=str(ck),
                              device="cpu")
    assert out.read_bytes() == jax_streamed
    with pytest.raises(ValueError, match="different parameters"):
        recalibrate_bam_streaming(inputs["plain"], str(out),
                                  RecalConfig(**dict(CFG, k=15)),
                                  checkpoint_dir=str(ck), device="cpu")


def test_jax_resumes_from_the_ports_checkpoint(d, inputs, jax_streamed):
    ck = d / "t_ck"
    out = d / "t_ck.bam"
    recalibrate_bam_streaming(inputs["plain"], str(out), RecalConfig(**CFG),
                              set_oq=True, checkpoint_dir=str(ck),
                              chunk_records=1000, device="cpu")
    assert out.read_bytes() == jax_streamed
    t_meta = json.loads((ck / "meta.json").read_text())
    j_meta = json.loads((d / "j_ck" / "meta.json").read_text())
    assert t_meta == j_meta
    for f in ("rows_a.npy", "rows_b.npy", "cov_cyc_total.npy",
              "cov_din_errors.npy"):
        assert np.array_equal(np.load(ck / f), np.load(d / "j_ck" / f))
    j_out = d / "j_from_t_ck.bam"
    j_recalibrate_bam_streaming(inputs["plain"], str(j_out),
                                JRecalConfig(**CFG), set_oq=True,
                                checkpoint_dir=str(ck))
    assert j_out.read_bytes() == jax_streamed


@pytest.mark.parametrize("route", ["whole", "windowed"])
def test_report_out_and_apply_report(d, inputs, jax_files, route):
    """report_out = the JAX package's report; apply_report (pass 4 only)
    writes the full run's bytes."""
    j_rep = d / "j.report"
    if not j_rep.exists():
        j_recalibrate_bam(inputs["plain"], str(d / "j_rep.bam"),
                          JRecalConfig(**CFG), report_out=str(j_rep))
    run = recalibrate_bam if route == "whole" else recalibrate_bam_streaming
    rep, full, applied = (d / f"{route}{x}" for x in (".report", "_full.bam",
                                                      "_applied.bam"))
    run(inputs["plain"], str(full), RecalConfig(**CFG), report_out=str(rep),
        device="cpu")
    assert rep.read_bytes() == j_rep.read_bytes()
    run(inputs["plain"], str(applied), RecalConfig(**CFG),
        apply_report=str(rep), device="cpu")
    assert applied.read_bytes() == full.read_bytes() == \
        jax_files["plain", False, False]


# -------------------------------------------------------- BAM and FASTQ

def test_one_group_bam_gives_the_fastq_qualities(d):
    """Reads as a one-group BAM (half reverse strand) and as FASTQ, in the
    same order: the same recalibrated qualities."""
    bf = bam_records(rg=False, extra=False)
    src = write_bam(d / "one.bam", bf)
    fq = bytearray()
    for rec in bf.records:
        c, q = jbam.machine_order_read(rec)
        q = np.clip(q.astype(np.int16) + 256 * (q < 0), 0, 93)
        mate = "2" if rec.is_read2 else "1"
        fq += b"@%s/%s\n%s\n+\n%s\n" % (
            rec.name.encode(), mate.encode(), bytes(b"ACGTN"[x] for x in c),
            bytes((q + 33).astype(np.uint8)))
    (d / "one.fq").write_bytes(bytes(fq))
    recalibrate_bam(src, str(d / "one_out.bam"), RecalConfig(**CFG),
                    device="cpu")
    recalibrate_fastq(str(d / "one.fq"), str(d / "one_out.fq"),
                      RecalConfig(**CFG), device="cpu")
    got = [tbam.machine_order_read(r)[1]
           for r in tbam.read_bam(str(d / "one_out.bam")).records]
    lines = (d / "one_out.fq").read_bytes().split(b"\n")[3::4]
    want = [np.frombuffer(x, np.uint8).astype(np.int8) - 33
            for x in lines[:len(got)]]
    assert len(got) == len(bf.records)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)

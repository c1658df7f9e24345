"""CRAM in the port (io/cram_codecs.py, io/cram.py, io/cram_write.py,
utils/synth.py::arrays_to_cram_bytes, pipeline/bam.py::recalibrate_cram)
against the JAX package on the same records, made from a seed: the varints,
the rANS coder (native, its NumPy version and the JAX package's NumPy
coder), the reader on every fixture shape of tests/test_cram.py, corrupt
input, the writer and the whole-file route's files.  CRAM's gzip blocks
stamp the clock, so every byte comparison of two writes pins it.  On the
CPU (the kernels' plain versions).  Tolerance: exact equality.
"""

import struct
import time

import numpy as np
import pytest

from kbbq_tpu.io import bam as jbam
from kbbq_tpu.io import cram as jcram
from kbbq_tpu.io import cram_codecs as jcodecs
from kbbq_tpu.io import native_lib as jnative
from kbbq_tpu.io.cram_write import write_cram as j_write_cram
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline.bam import recalibrate_cram as j_recalibrate_cram

from kbbq_tpu_torch.io import cram as tcram
from kbbq_tpu_torch.io import cram_codecs as tcodecs
from kbbq_tpu_torch.io.cram_write import write_cram
from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_cram

from test_cram import _mixed_records, _ref_records

CFG = dict(k=17, coverage=20.0, batch_size=64)
CLOCK = 1.7e9


@pytest.fixture
def pinned(monkeypatch):
    """One clock for every gzip block written in the test."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)


@pytest.fixture
def jax_numpy_rans(monkeypatch):
    """The JAX package's rANS on its NumPy coder (its native library
    unused)."""
    monkeypatch.setattr(jnative, "rans_compress", lambda *a: None)
    monkeypatch.setattr(jnative, "rans_uncompress", lambda *a: None)


# ---------------------------------------------------------------- varints

ITF8 = [0, 1, 127, 128, 16383, 16384, 2 ** 20, 2 ** 21 - 1, 2 ** 21,
        2 ** 27, 2 ** 28 - 1, 2 ** 28, 2 ** 31 - 1, 0xFFFFFFFF, -1, -2 ** 31]
LTF8 = [0, 127, 128, 2 ** 14, 2 ** 21, 2 ** 28, 2 ** 35, 2 ** 40, 2 ** 49,
        2 ** 55, 2 ** 56, 2 ** 62, -1]


@pytest.mark.parametrize("v", ITF8)
def test_itf8_equals_the_jax_packages(v):
    b = tcodecs.write_itf8(v)
    assert b == jcodecs.write_itf8(v)
    assert tcodecs.read_itf8(b + b"\x00", 0) == jcodecs.read_itf8(b, 0)


@pytest.mark.parametrize("v", LTF8)
def test_ltf8_equals_the_jax_packages(v):
    b = tcodecs.write_ltf8(v)
    assert b == jcodecs.write_ltf8(v)
    assert tcodecs.read_ltf8(b, 0) == jcodecs.read_ltf8(b, 0)


@pytest.mark.parametrize("seed", range(3))
def test_itf8_array_encodes_a_column_as_write_itf8_does(seed):
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.integers(-2 ** 31, 2 ** 32, 4000),
                        rng.integers(0, 300, 4000), np.asarray(ITF8)])
    want = b"".join(jcodecs.write_itf8(int(x)) for x in v)
    assert tcodecs.write_itf8_array(v) == want
    assert tcodecs.write_itf8_array(np.zeros(0, np.int64)) == b""


# ------------------------------------------------------------------- rANS

def _rans_cases():
    rng = np.random.default_rng(1)
    qual = np.clip(rng.normal(30, 6, 3000), 2, 41).astype(np.uint8)
    return {
        "empty": b"", "one_byte": b"a", "one_symbol": b"\x07" * 3000,
        "two_symbols": b"AB" * 700,
        "o0_o1_switch_999": bytes(rng.integers(60, 70, 999).astype(np.uint8)),
        "o0_o1_switch_1000": bytes(rng.integers(0, 4, 1000).astype(np.uint8)),
        "o0_o1_switch_1001": bytes(rng.integers(0, 256, 1001).astype(
            np.uint8)),
        "quarters_uneven": bytes(rng.integers(0, 9, 1003).astype(np.uint8)),
        "uniform_256": bytes(rng.integers(0, 256, 5003).astype(np.uint8)),
        "skewed_bases": bytes(rng.choice([65, 67, 71, 84], 4001,
                                         p=[.4, .3, .2, .1]).astype(np.uint8)),
        "qualities": bytes(qual),
        "text": b"hello world, " * 77,
    }


RANS = _rans_cases()


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name", sorted(RANS))
def test_rans_native_plain_and_jax_numpy_coders_agree(name, order,
                                                      jax_numpy_rans):
    data = RANS[name]
    comp = {0: tcodecs.rans_compress_o0, 1: tcodecs.rans_compress_o1}[order]
    plain = {0: tcodecs.rans_compress_o0_plain,
             1: tcodecs.rans_compress_o1_plain}[order]
    jax = {0: jcodecs.rans_compress_o0, 1: jcodecs.rans_compress_o1}[order]
    blob = comp(data)
    assert blob == plain(data) == jax(data)
    assert blob[0] == order
    assert tcodecs.rans_uncompress(blob, len(data)) == data
    assert tcodecs.rans_uncompress_plain(blob, len(data)) == data
    assert jcodecs.rans_uncompress(blob) == data


def _o0_blob_with_table(freqs: dict) -> bytes:
    """An order-0 blob of 8 output bytes whose table holds `freqs`."""
    F = np.zeros(256, np.int64)
    for s, f in freqs.items():
        F[s] = f
    body = jcodecs._write_freq_table(F) + struct.pack("<4I", *[1 << 23] * 4)
    return bytes([0]) + struct.pack("<II", len(body), 8) + body


MALFORMED = {
    "short_header": (b"\x00\x01\x02", None),
    "declared_size": (tcodecs.rans_compress_o0(b"abc" * 10), 31),
    "unknown_order": (bytes([7]) + tcodecs.rans_compress_o0(b"abc")[1:],
                      None),
    "no_table": (bytes([0]) + struct.pack("<II", 0, 30), None),
    "cut_states": (tcodecs.rans_compress_o0(b"abcd" * 50)[:20], None),
    "cut_o1_table": (tcodecs.rans_compress_o1(RANS["text"])[:40], None),
    "table_past_4096": (_o0_blob_with_table({65: 3000, 66: 3000}), None),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_a_malformed_blob_raises(name):
    blob, expected = MALFORMED[name]
    with pytest.raises(ValueError, match="rANS"):
        tcodecs.rans_uncompress(blob, expected)


# ----------------------------------------------------------------- reader

def _same_decode(t, j):
    """The port's read_cram result equals the JAX package's."""
    (tbf, tnames), (jbf, jnames) = t, j
    assert tnames == jnames
    assert tbf.header_text == jbf.header_text and tbf.refs == jbf.refs
    assert len(tbf.records) == len(jbf.records)
    for a, b in zip(tbf.records, jbf.records):
        assert bytes(a.data) == bytes(b.data), a.name
        assert a._cram_rg == b._cram_rg


def _fixture(tmp_path, shape):
    """(path, fasta path or None) of one of tests/test_cram.py's shapes."""
    p = tmp_path / f"{shape}.cram"
    fa = None
    if shape in ("mixed", "containers", "multi_slice"):
        bf = _mixed_records(seed=5, n=50 if shape == "mixed" else 60)
        kw = {"mixed": {}, "containers": dict(records_per_container=10),
              "multi_slice": dict(records_per_container=30,
                                  records_per_slice=8)}[shape]
        j_write_cram(bf, str(p), **kw)
        return p, fa
    bf, ref_bytes = _ref_records(seed=53)
    fa = tmp_path / "ref.fa"
    fa.write_text(">chr1\n" + ref_bytes.decode() + "\n")
    kw = {"ref_external": {}, "ref_embedded": dict(embed_ref=True),
          "ref_multi_slice": dict(records_per_container=30,
                                  records_per_slice=7),
          "ref_multi_slice_embedded": dict(records_per_container=30,
                                           records_per_slice=7,
                                           embed_ref=True)}[shape]
    j_write_cram(bf, str(p), ref={"chr1": ref_bytes}, **kw)
    return p, fa


SHAPES = ["mixed", "containers", "multi_slice", "ref_external",
          "ref_embedded", "ref_multi_slice", "ref_multi_slice_embedded"]


@pytest.mark.parametrize("shape", SHAPES)
def test_reader_decodes_every_fixture_shape_as_the_jax_package(tmp_path,
                                                               shape):
    p, fa = _fixture(tmp_path, shape)
    kw = {"fasta_ref": str(fa)} if fa is not None and "emb" not in shape \
        else {}
    _same_decode(tcram.read_cram(str(p), **kw), jcram.read_cram(str(p), **kw))


def test_reference_based_without_a_reference_raises(tmp_path):
    p, _ = _fixture(tmp_path, "ref_external")
    with pytest.raises(tcram.CRAMError, match="fasta-ref"):
        tcram.read_cram(str(p))
    # every base an X substitution: never reaches the reference fill
    rng = np.random.default_rng(3)
    ref_codes = rng.integers(0, 4, 200)
    ref_bytes = np.frombuffer(b"ACGT", np.uint8)[ref_codes].tobytes()
    codes = ((ref_codes[50:90] + 1) % 4).astype(np.int8)
    rec = jbam.build_record("rX", codes, np.full(40, 30, np.uint8), flag=0,
                            refid=0, pos=50, cigar=[("M", 40)])
    rec._rg_index = 0
    bf = jbam.BamFile("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:200\n@RG\tID:g0\n",
                      [("chr1", 200)], [rec])
    p2 = tmp_path / "allx.cram"
    j_write_cram(bf, str(p2), ref={"chr1": ref_bytes})
    with pytest.raises(tcram.CRAMError, match="fasta-ref"):
        tcram.read_cram(str(p2))


def test_trailing_container_padding(tmp_path):
    bf = _mixed_records(n=12)
    p = tmp_path / "t.cram"
    j_write_cram(bf, str(p))
    blob = p.read_bytes()
    buf = np.frombuffer(blob, np.uint8)
    cont, _ = jcram.read_container_header(buf, 26)
    start = cont.body_pos + cont.length
    cont2, _ = jcram.read_container_header(buf, start)
    end = cont2.body_pos + cont2.length
    pad = 37
    padded = tmp_path / "padded.cram"
    padded.write_bytes(blob[:start] + struct.pack("<i", cont2.length + pad)
                       + blob[start + 4:end] + b"\x00" * pad + blob[end:])
    _same_decode(tcram.read_cram(str(padded)),
                 jcram.read_cram(str(padded)))


def _arr(vals):
    out = jcodecs.write_itf8(len(vals))
    for v in vals:
        out += jcodecs.write_itf8(v)
    return out


def _ext(cid):
    p = jcodecs.write_itf8(cid)
    return jcodecs.write_itf8(1) + jcodecs.write_itf8(len(p)) + p


@pytest.mark.parametrize("case", ["huffman", "huffman_ties", "beta",
                                  "byte_array_len", "byte_array_stop"])
def test_core_bit_and_array_decoders(case):
    """HUFFMAN (canonical, ties by symbol), BETA, BYTE_ARRAY_LEN and
    BYTE_ARRAY_STOP on hand-built parameters: the JAX package's values."""
    if case in ("huffman", "huffman_ties"):
        syms, lens = ([5, 6, 7], [1, 2, 2]) if case == "huffman" else \
            ([7, 5, 6], [2, 1, 2])
        enc, core, streams, n = (3, _arr(syms) + _arr(lens)), \
            bytes([0b01011000]), {}, 4
    elif case == "beta":
        enc, core, streams, n = (6, jcodecs.write_itf8(2)
                                 + jcodecs.write_itf8(3)), \
            bytes([0b10100100, 0b11100000]), {}, 3
    elif case == "byte_array_len":
        enc, core, n = (4, _ext(1) + _ext(2)), b"", 2
        streams = {1: jcodecs.write_itf8(3) + jcodecs.write_itf8(2),
                   2: b"abcde"}
    else:
        enc, core, n = (5, bytes([0]) + jcodecs.write_itf8(3)), b"", 3
        streams = {3: b"ab\x00\x00xyz\x00"}
    out = []
    for mod in (tcram, jcram):
        dec = mod.Decoder(enc, {c: mod.Stream(v) for c, v in streams.items()},
                          mod.BitReader(core))
        get = dec.get_int if case in ("huffman", "huffman_ties", "beta") \
            else dec.get_bytes
        out.append([get() for _ in range(n)])
    assert out[0] == out[1]


def _corruptions(blob):
    cuts = {f"cut_{c}": blob[:c] for c in (3, 30, 100, len(blob) // 2,
                                            len(blob) - 40, len(blob) - 1)}
    flips = {}
    for at in (len(blob) // 3, len(blob) // 2, len(blob) - 60):
        b = bytearray(blob)
        b[at] ^= 0xFF
        flips[f"flip_{at}"] = bytes(b)
    return {"magic": b"XRAM" + blob[4:],
            "version": b"CRAM" + bytes([9, 0]) + blob[6:], **cuts, **flips}


def _outcome(fn):
    try:
        bf, names = fn()
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e).__name__
    return [bytes(r.data) for r in bf.records], names


def test_corrupt_and_truncated_inputs_fail_as_in_the_jax_package(tmp_path):
    bf = _mixed_records(n=10)
    p = tmp_path / "ok.cram"
    j_write_cram(bf, str(p))
    bad = tmp_path / "bad.cram"
    failed = 0
    for name, blob in _corruptions(p.read_bytes()).items():
        bad.write_bytes(blob)
        got = _outcome(lambda: tcram.read_cram(str(bad)))
        want = _outcome(lambda: jcram.read_cram(str(bad)))
        assert got == want, name
        failed += isinstance(got, str)
    assert failed >= 8


@pytest.mark.parametrize("skip", [0, 1, 3, 9])
def test_container_stream_and_skip(tmp_path, skip):
    bf = _mixed_records(seed=8, n=37)
    p = tmp_path / "t.cram"
    j_write_cram(bf, str(p), records_per_container=10)
    with tcram.CramStream(str(p)) as t, jcram.CramStream(str(p)) as j:
        assert (t.header_text, t.rg_names, t.ref_names) == \
            (j.header_text, j.rg_names, j.ref_names)
        tl = [(c.counter, c.n_records, raw) for c, _, raw in
              t.containers(skip)]
        jl = [(c.counter, c.n_records, raw) for c, _, raw in
              j.containers(skip)]
    assert tl == jl and len(tl) == max(0, 4 - skip)


# ----------------------------------------------------------------- writer

WRITES = {
    "mixed": dict(),
    "containers": dict(records_per_container=10),
    "multi_slice": dict(records_per_container=30, records_per_slice=8),
    "ref": dict(ref=True),
    "ref_embedded": dict(ref=True, embed_ref=True),
    "ref_multi_slice": dict(ref=True, embed_ref=True,
                            records_per_container=30, records_per_slice=7),
}


@pytest.mark.parametrize("name", sorted(WRITES))
def test_writer_gives_the_jax_packages_bytes(tmp_path, name, pinned):
    kw = dict(WRITES[name])
    if kw.pop("ref", False):
        bf, ref_bytes = _ref_records(seed=13)
        kw["ref"] = {"chr1": ref_bytes}
    else:
        bf = _mixed_records(seed=5, n=60)
    t, j = tmp_path / "t.cram", tmp_path / "j.cram"
    write_cram(bf, str(t), **kw)
    j_write_cram(bf, str(j), **kw)
    assert t.read_bytes() == j.read_bytes()


@pytest.mark.parametrize("extra_share,per_container,oq", [
    (0.1, 250, False), (0.0, 100000, False), (0.05, 300, True)])
def test_synthetic_cram_writer_equals_write_cram(tmp_path, pinned,
                                                 extra_share, per_container,
                                                 oq):
    """utils/synth.py::arrays_to_cram_bytes gives write_cram's bytes for
    the records arrays_to_bam_bytes writes (each record's RG the index of
    its group among the header's @RG lines)."""
    from kbbq_tpu_torch.io.bam import parse_bam_bytes, read_bam_bytes
    from kbbq_tpu_torch.pipeline.bam import (_assign_cram_rg,
                                             bam_read_group_ids)
    from kbbq_tpu_torch.utils.synth import (arrays_to_bam_bytes,
                                            arrays_to_cram_bytes,
                                            make_arrays_fast, read_starts)
    a, _ = make_arrays_fast(genome_len=4000, read_len=41, num_reads=600,
                            seed=1)
    starts = read_starts(4000, 41, 600, 1)
    oq_quals = ((a.quals.astype(np.int64) * 3) % 41).astype(np.int8) \
        if oq else None
    data, rows = arrays_to_bam_bytes(a, starts, extra_share=extra_share,
                                     oq_quals=oq_quals)
    (tmp_path / "s.bam").write_bytes(data)
    bf = parse_bam_bytes(read_bam_bytes(str(tmp_path / "s.bam")))
    prim = [r for r in bf.records if not r.is_secondary_or_supp]
    rgs, registry = bam_read_group_ids(bf, prim)
    _assign_cram_rg(bf, prim, rgs, registry)
    write_cram(bf, str(tmp_path / "w.cram"),
               records_per_container=per_container)
    got, rows2 = arrays_to_cram_bytes(a, starts, extra_share=extra_share,
                                      oq_quals=oq_quals,
                                      records_per_container=per_container)
    assert got == (tmp_path / "w.cram").read_bytes()
    assert np.array_equal(rows, rows2)
    # the JAX package reads it back: the generator's rows, in file order
    (tmp_path / "s.cram").write_bytes(got)
    jbf, _ = jcram.read_cram(str(tmp_path / "s.cram"))
    jprim = [r for r in jbf.records if not r.is_secondary_or_supp]
    assert len(jprim) == 600
    for j, want in ((0, a.codes), (1, a.quals if not oq else oq_quals)):
        assert np.array_equal(
            np.stack([jbam.machine_order_read(r, use_oq=oq)[j]
                      for r in jprim]), want[rows])


# ------------------------------------------------------- whole-file route

def _recal_input(tmp_path, kind):
    """(cram path, fasta path or None) for the whole-file route."""
    p = tmp_path / f"in_{kind}.cram"
    if kind == "mixed":
        j_write_cram(_mixed_records(seed=9, n=160), str(p),
                     records_per_container=64, records_per_slice=24)
        return p, None
    if kind == "header_order":
        # the first record carries the header's SECOND read group
        bf = _mixed_records(seed=19, n=120)
        for i, rec in enumerate(bf.records):
            rec._rg_index = 1 if i % 5 else 0
        j_write_cram(bf, str(p), records_per_container=50)
        return p, None
    if kind == "high_quals":
        # QS bytes >= 128 and OQ bytes >= 161 on primary records
        bf = _mixed_records(seed=23, n=120)
        for i, rec in enumerate(bf.records):
            if i % 9 == 2:
                rec.data[rec.qual_off] = 200
                rec.data[bytes(rec.data).index(b"OQZ", rec.aux_off) + 4] = 220
        j_write_cram(bf, str(p))
        return p, None
    bf, ref_bytes = _ref_records(seed=41)
    fa = tmp_path / "ref.fa"
    fa.write_text(">chr1\n" + ref_bytes.decode() + "\n")
    j_write_cram(bf, str(p), ref={"chr1": ref_bytes},
                 records_per_container=16)
    return p, fa


@pytest.mark.parametrize("ext", ["cram", "bam", "sam"])
@pytest.mark.parametrize("kind,use_oq,set_oq", [
    ("mixed", False, False), ("mixed", False, True), ("mixed", True, False),
    ("header_order", False, True), ("high_quals", False, False),
    ("high_quals", True, True), ("ref", False, False)])
def test_whole_file_route_writes_the_jax_packages_bytes(tmp_path, pinned,
                                                        ext, kind, use_oq,
                                                        set_oq):
    src, fa = _recal_input(tmp_path, kind)
    kw = dict(use_oq=use_oq, set_oq=set_oq,
              fasta_ref=None if fa is None else str(fa))
    t, j = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    info = recalibrate_cram(str(src), str(t), RecalConfig(**CFG),
                            device="cpu", **kw)
    j_info = j_recalibrate_cram(str(src), str(j), JRecalConfig(**CFG), **kw)
    assert t.read_bytes() == j.read_bytes()
    assert info == j_info


def test_report_out_and_apply_report(tmp_path, pinned):
    src, _ = _recal_input(tmp_path, "header_order")
    cfg = RecalConfig(**CFG)
    r_t, r_j = tmp_path / "t.report", tmp_path / "j.report"
    recalibrate_cram(str(src), str(tmp_path / "a.cram"), cfg, device="cpu",
                     report_out=str(r_t))
    j_recalibrate_cram(str(src), str(tmp_path / "b.cram"),
                       JRecalConfig(**CFG), report_out=str(r_j))
    assert r_t.read_bytes() == r_j.read_bytes()
    recalibrate_cram(str(src), str(tmp_path / "c.cram"), cfg, device="cpu",
                     apply_report=str(r_j))
    assert (tmp_path / "c.cram").read_bytes() == \
        (tmp_path / "a.cram").read_bytes()


def test_bam_input_to_cram_output(tmp_path, pinned):
    """recalibrate_bam(in.bam, out.cram): the JAX package's bytes."""
    from kbbq_tpu.pipeline.bam import recalibrate_bam as j_recalibrate_bam
    from kbbq_tpu_torch.pipeline import recalibrate_bam
    bf = _mixed_records(seed=29, n=150)
    for i, rec in enumerate(bf.records):
        rec.data.extend(b"RGZ" + (b"g1" if i % 3 else b"g0") + b"\x00")
    src = tmp_path / "in.bam"
    src.write_bytes(jbam.serialize_bam(bf))
    recalibrate_bam(str(src), str(tmp_path / "t.cram"), RecalConfig(**CFG),
                    set_oq=True, device="cpu")
    j_recalibrate_bam(str(src), str(tmp_path / "j.cram"),
                      JRecalConfig(**CFG), set_oq=True)
    assert (tmp_path / "t.cram").read_bytes() == \
        (tmp_path / "j.cram").read_bytes()


def test_several_devices_refused(tmp_path, monkeypatch):
    """Several devices run (tests/test_torch_parallel.py), the
    hash-space-sharded layout too: on two ranks it writes one device's
    bytes (both writes under one pinned clock: gzip blocks stamp it);
    refused are more devices than there are, before anything is
    written."""
    import time
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    src, _ = _recal_input(tmp_path, "mixed")
    for name, kw in (("one", {}), ("sharded", dict(
            devices=2, bloom_layout="sharded"))):
        recalibrate_cram(str(src), str(tmp_path / f"{name}.cram"),
                         RecalConfig(**CFG), device="cpu", **kw)
    assert (tmp_path / "sharded.cram").read_bytes() == \
        (tmp_path / "one.cram").read_bytes()
    with pytest.raises(ValueError, match="requested but only"):
        recalibrate_cram(str(src), str(tmp_path / "x.cram"),
                         RecalConfig(**CFG), devices=100000, device="cpu")
    assert not (tmp_path / "x.cram").exists()


def test_timings_name_the_host_stages(tmp_path):
    src, _ = _recal_input(tmp_path, "mixed")
    t: dict = {}
    recalibrate_cram(str(src), str(tmp_path / "x.bam"), RecalConfig(**CFG),
                     device="cpu", timings=t)
    for stage in ("read", "decode", "pass1", "pass3", "pass4", "rewrite",
                  "write"):
        assert stage in t

"""SAM in the port (io/sam.py and the SAM half of pipeline/bam.py) against
the JAX package on the same text, made from a seed: parse, emit, and the
files of SAM -> SAM and SAM -> BAM recalibration, with read groups,
reverse-strand, pass-through and empty records, --use-oq and --set-oq.
On the CPU.  Tolerance: exact equality.
"""

import gzip

import numpy as np
import pytest

from kbbq_tpu.io import sam as jsam
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline.bam import recalibrate_bam as j_recalibrate_bam

from kbbq_tpu_torch.io import sam as tsam
from kbbq_tpu_torch.io.bam import BAMError
from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_bam

from test_torch_bam import CFG, bam_records

SAM = (
    "@HD\tVN:1.6\tSO:coordinate\n"
    "@SQ\tSN:chr1\tLN:1000\n"
    "@SQ\tSN:chr2\tLN:500\n"
    "@RG\tID:g1\tPU:unit1\n"
    "r1\t0\tchr1\t100\t60\t5M\t*\t0\t0\tACGTA\tIIIII\tRG:Z:g1\n"
    "r2\t16\tchr2\t7\t30\t3M2S\t=\t7\t0\tGGTTA\t!!!FF\t"
    "RG:Z:g1\tNM:i:2\tAS:i:-3\tXF:f:1.5\tXB:B:s,-1,2\tXC:B:f,0.5\n"
    "r3\t4\t*\t0\t0\t*\t*\t0\t0\tTTTT\t####\tXA:A:q\tXH:H:1AE3\n"
    "r4\t4\t*\t0\t0\t*\tchr1\t9\t0\t*\t*\n"
)


def _texts():
    return {"fixture": SAM,
            "records": jsam.serialize_sam(bam_records()).decode(),
            "oq": jsam.serialize_sam(bam_records(oq="some")).decode(),
            "odd": jsam.serialize_sam(
                bam_records(odd="unterminated")).decode()}


@pytest.mark.parametrize("name", ["fixture", "records", "oq", "odd"])
def test_parse_and_emit_match(name):
    """parse_sam_text / record_to_sam_line / serialize_sam: the JAX
    package's records and text."""
    text = _texts()[name]
    got, want = tsam.parse_sam_text(text), jsam.parse_sam_text(text)
    assert (got.header_text, got.refs) == (want.header_text, want.refs)
    names = [n for n, _ in want.refs]
    for a, b in zip(got.records, want.records, strict=True):
        assert bytes(a.data) == bytes(b.data)
        assert (a.flag, a.l_seq, a.name, a.seq_off, a.qual_off, a.aux_off,
                a.refid, a.pos) == (b.flag, b.l_seq, b.name, b.seq_off,
                                    b.qual_off, b.aux_off, b.refid, b.pos)
        assert tsam.record_to_sam_line(a, names) == \
            jsam.record_to_sam_line(b, names)
    assert tsam.serialize_sam(got) == jsam.serialize_sam(want)


@pytest.mark.parametrize("bad,match", [
    ("r\t0\tchrX\t1\t0\t2M\t*\t0\t0\tAC\tII\n", "unknown sequence"),
    ("r\t0\tchr1\t1\t0\t2Q\t*\t0\t0\tAC\tII\n", "bad CIGAR op"),
    ("r\t0\tchr1\t1\t0\t2M\t*\t0\t0\tAC\tIII\n", "length mismatch"),
    ("r\t0\tchr1\t1\t0\t2M\t*\t0\t0\tAC\tII\tXX:Y:1\n", "unknown SAM aux"),
    ("r\t0\tchr1\t1\n", "fields"),
])
def test_malformed_lines_raise_the_jax_packages_error(bad, match):
    text = SAM.split("\nr1\t")[0] + "\n" + bad
    with pytest.raises(BAMError) as got:
        tsam.parse_sam_text(text)
    with pytest.raises(ValueError) as want:
        jsam.parse_sam_text(text)
    assert str(got.value) == str(want.value) and match in str(got.value)


@pytest.fixture(scope="module")
def sams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sam")
    texts = _texts()
    plain, oq = d / "in.sam", d / "in_oq.sam.gz"
    plain.write_text(texts["records"])
    oq.write_bytes(gzip.compress(texts["oq"].encode()))
    return d, {"plain": str(plain), "oq": str(oq)}


def test_read_sam_plain_and_gz(sams):
    _, paths = sams
    for p in paths.values():
        got, want = tsam.read_sam(p), jsam.read_sam(p)
        assert [bytes(r.data) for r in got.records] == \
            [bytes(r.data) for r in want.records]


@pytest.mark.parametrize("src,out,use_oq,set_oq", [
    ("plain", "sam", False, False), ("plain", "sam", False, True),
    ("plain", "bam", False, True), ("oq", "sam", False, True),
    ("oq", "bam", False, False)])
def test_sam_routes_write_the_jax_packages_bytes(sams, src, out, use_oq,
                                                 set_oq):
    """SAM -> SAM and SAM -> BAM by the output's extension (.sam.gz input
    too): the JAX package's bytes."""
    d, paths = sams
    t, j = d / f"t_{src}_{set_oq}.{out}", d / f"j_{src}_{set_oq}.{out}"
    info = recalibrate_bam(paths[src], str(t), RecalConfig(**CFG),
                           use_oq=use_oq, set_oq=set_oq, device="cpu")
    j_info = j_recalibrate_bam(paths[src], str(j), JRecalConfig(**CFG),
                               use_oq=use_oq, set_oq=set_oq)
    assert t.read_bytes() == j.read_bytes()
    assert info == j_info


def test_use_oq_needs_an_oq_tag_on_every_primary(sams):
    d, paths = sams
    with pytest.raises(BAMError, match="has no OQ tag"):
        recalibrate_bam(paths["oq"], str(d / "never.sam"),
                        RecalConfig(**CFG), use_oq=True, device="cpu")


def test_qual_star_reads_as_each_jax_route_reads_it():
    """A QUAL of "*" (0xff): the record model (SAM input) reads it as Q0,
    the vectorised BAM decode as Q93, in the JAX package and in the
    port."""
    from kbbq_tpu.io import bam as jbam
    from kbbq_tpu.io import bam_vec as jvec
    from kbbq_tpu_torch.io import bam as tbam
    from kbbq_tpu_torch.io import bam_vec as tvec
    text = SAM.replace("ACGTA\tIIIII", "ACGTA\t*")
    got = []
    for sam, bam, vec in ((tsam, tbam, tvec), (jsam, jbam, jvec)):
        bf = sam.parse_sam_text(text)
        q = np.clip(bam.machine_order_read(bf.records[0])[1], 0, 93)
        _, buf, offs, sizes = bam.parse_bam_bytes_indexed(
            bam.serialize_bam(bf, compress=False))
        dec = vec.decode_machine_chunk(buf, offs, sizes, 5, {"g1": 0, "": 1})
        got.append((q.tolist(), dec[1][0].tolist()))
    assert got[0] == got[1] == ([0] * 5, [93] * 5)

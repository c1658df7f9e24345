"""BAM codec: the record model, header, whole-file read and write.

Counterpart of ``kbbq_tpu/io/bam.py``: BGZF-wrapped binary records as the
SAM/BAM spec lays them out, with the port's native record index
(``io/native_lib.py::bam_offsets``) in place of a Python walk over the
block sizes.  kbbq-specific semantics (DECISIONS.md D8):

- reads are returned in machine order: reverse-strand alignments are
  reverse-complemented and their quals reversed;
- RG aux tag -> dense read-group index (registry built by the caller);
- --use-oq: take base qualities from the OQ:Z: tag;
- --set-oq: writer adds/overwrites OQ:Z: with the original quals;
- secondary (0x100) and supplementary (0x800) alignments are passed
  through on write but excluded from recalibration;
- the writer rewrites ONLY the QUAL field (plus optional OQ), preserving
  all other bytes of every record.

The whole-chunk decode and rewrite that the pipelines run are in
``io/bam_vec.py``; this module's per-record functions serve SAM, the
records that the vectorised aux walk refuses, and the tests.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct

import numpy as np

from . import bgzf, native_lib

BAM_MAGIC = b"BAM\x01"
# 4-bit nibble code -> our 2-bit code (A=0 C=1 G=2 T=3, else N=4)
NIBBLE_TO_CODE = np.full(16, 4, dtype=np.int8)
NIBBLE_TO_CODE[1] = 0   # A
NIBBLE_TO_CODE[2] = 1   # C
NIBBLE_TO_CODE[4] = 2   # G
NIBBLE_TO_CODE[8] = 3   # T
CODE_TO_NIBBLE = np.array([1, 2, 4, 8, 15], dtype=np.uint8)

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

_AUX_SIZES = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
              ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}
_CIGAR_OP_CODES = {c: i for i, c in enumerate("MIDNSHP=X")}


class BAMError(ValueError):
    pass


@dataclasses.dataclass
class BamRecord:
    """One alignment, with byte offsets into its record body.

    `data` is the record body (after the 4-byte block_size), so offsets
    are stable for in-place qual rewriting.
    """
    data: bytearray
    flag: int
    l_seq: int
    name: str
    seq_off: int      # offset of packed seq within data
    qual_off: int     # offset of qual within data
    aux_off: int      # offset of aux region within data
    refid: int
    pos: int

    def seq_codes(self) -> np.ndarray:
        """2-bit codes in ALIGNMENT orientation (not yet machine order)."""
        end = self.seq_off + (self.l_seq + 1) // 2
        nb = np.frombuffer(bytes(self.data[self.seq_off:end]), dtype=np.uint8)
        inter = np.empty(2 * nb.size, dtype=np.uint8)
        inter[0::2] = nb >> 4
        inter[1::2] = nb & 0xF
        return NIBBLE_TO_CODE[inter[:self.l_seq]]

    def quals(self) -> np.ndarray:
        q = np.frombuffer(bytes(self.data[self.qual_off:
                                          self.qual_off + self.l_seq]),
                          dtype=np.uint8)
        return q.astype(np.int16)

    def aux_tags(self):
        """Parse aux region -> {tag: (type, value)}; values for Z/H are
        bytes, B arrays are raw bytes."""
        out = {}
        d = self.data
        i = self.aux_off
        n = len(d)
        while i + 3 <= n:
            tag = bytes(d[i:i + 2]).decode("ascii", "replace")
            typ = d[i + 2]
            i += 3
            if typ in _AUX_SIZES:
                size = _AUX_SIZES[typ]
                val = bytes(d[i:i + size])
                i += size
            elif typ in (ord("Z"), ord("H")):
                j = i
                while j < n and d[j] != 0:
                    j += 1
                val = bytes(d[i:j])
                i = j + 1
            elif typ == ord("B"):
                sub = d[i]
                cnt = struct.unpack_from("<I", d, i + 1)[0]
                size = _AUX_SIZES[sub] * cnt
                val = bytes(d[i:i + 5 + size])
                i += 5 + size
            else:
                raise BAMError(f"unknown aux type {chr(typ)} in {self.name}")
            out[tag] = (chr(typ), val)
        return out

    def get_zstr(self, tag: str) -> bytes | None:
        t = self.aux_tags().get(tag)
        if t and t[0] == "Z":
            return t[1]
        return None

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_read2(self) -> bool:
        return bool(self.flag & FLAG_READ2)

    @property
    def is_secondary_or_supp(self) -> bool:
        return bool(self.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY))


@dataclasses.dataclass
class BamFile:
    header_text: str
    refs: list
    records: list

    @property
    def num_records(self):
        return len(self.records)


def record_from_body(body: bytearray) -> BamRecord:
    """BamRecord from one alignment body (the bytes after block_size)."""
    (refid, pos, l_read_name, _mapq, _bin, n_cigar, flag, l_seq,
     _nrid, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", body, 0)
    name_off = 32
    name = bytes(body[name_off:name_off + l_read_name - 1]).decode()
    cigar_off = name_off + l_read_name
    seq_off = cigar_off + 4 * n_cigar
    qual_off = seq_off + (l_seq + 1) // 2
    aux_off = qual_off + l_seq
    return BamRecord(body, flag, l_seq, name, seq_off, qual_off, aux_off,
                     refid, pos)


def parse_bam_header(raw: bytes, off: int = 0):
    """(header_text, refs, next_offset) from a decompressed BAM stream."""
    if raw[off:off + 4] != BAM_MAGIC:
        raise BAMError("missing BAM magic")
    off += 4
    l_text = struct.unpack_from("<i", raw, off)[0]
    off += 4
    header_text = bytes(raw[off:off + l_text]).decode("utf-8", "replace")
    off += l_text
    n_ref = struct.unpack_from("<i", raw, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", raw, off)[0]
        off += 4
        name = bytes(raw[off:off + l_name - 1]).decode()
        off += l_name
        l_ref = struct.unpack_from("<i", raw, off)[0]
        off += 4
        refs.append((name, l_ref))
    return header_text, refs, off


def bam_header_bytes(header_text: str, refs) -> bytes:
    """The decompressed BAM header: magic, text, reference list."""
    htext = header_text.encode()
    out = [BAM_MAGIC, struct.pack("<i", len(htext)), htext,
           struct.pack("<i", len(refs))]
    for name, l_ref in refs:
        nb = name.encode() + b"\x00"
        out += [struct.pack("<i", len(nb)), nb, struct.pack("<i", l_ref)]
    return b"".join(out)


def index_bam_bytes(raw):
    """(header_text, refs, buf, offs, sizes) of a decompressed BAM stream:
    buf is a uint8 view of its alignment section, offs / sizes the int64
    body offsets into it and body sizes of every record (the native record
    index; no per-record object)."""
    header_text, refs, off = parse_bam_header(raw)
    buf = np.frombuffer(raw, np.uint8)[off:]
    offs, sizes, end = native_lib.bam_offsets(buf)
    if end != buf.size:
        raise BAMError(f"truncated BAM record at byte {off + end}")
    return header_text, refs, buf, offs, sizes


def parse_bam_bytes(raw: bytes) -> BamFile:
    """Parse a decompressed BAM byte stream."""
    return parse_bam_bytes_indexed(raw)[0]


def parse_bam_bytes_indexed(raw: bytes):
    """(BamFile, buf, offs, sizes): the parsed records plus a uint8 view
    of the alignment section with per-record body offsets/sizes, for
    whole-file vectorized field extraction (io/bam_vec.py)."""
    header_text, refs, buf, offs, sizes = index_bam_bytes(raw)
    records = [record_from_body(bytearray(buf[o:o + s].tobytes()))
               for o, s in zip(offs.tolist(), sizes.tolist())]
    return BamFile(header_text, refs, records), buf, offs, sizes


def read_bam_bytes(path: str) -> bytes:
    """The decompressed bytes of a BAM file: BGZF, plain gzip or raw."""
    with open(path, "rb") as f:
        return inflate_bam_bytes(f.read())


def inflate_bam_bytes(data: bytes) -> bytes:
    """The decompressed bytes of a BAM file's contents `data`: BGZF, plain
    gzip or raw."""
    if bgzf.is_bgzf(data[:18]):
        return bgzf.decompress(data)
    if data[:2] == b"\x1f\x8b":
        return gzip.decompress(data)
    return data


def read_bam(path: str) -> BamFile:
    return parse_bam_bytes(read_bam_bytes(path))


def machine_order_read(rec: BamRecord, use_oq: bool = False):
    """(codes, quals) in machine (sequencing) order per SURVEY.md §4.2."""
    codes = rec.seq_codes()
    if use_oq:
        oq = rec.get_zstr("OQ")
        if oq is None:
            raise BAMError(f"--use-oq: record {rec.name} has no OQ tag")
        quals = np.frombuffer(oq, dtype=np.uint8).astype(np.int16) - 33
    else:
        quals = rec.quals()
    if rec.is_reverse:
        codes = np.where(codes < 4, 3 - codes, codes)[::-1].astype(np.int8)
        quals = quals[::-1]
    return codes.astype(np.int8), quals.astype(np.int8)


def serialize_bam(bf: BamFile, compress: bool = True,
                  level: int = bgzf.DEFAULT_COMPRESS_LEVEL) -> bytes:
    """Re-serialize (records' `data` may have been modified/extended)."""
    out = [bam_header_bytes(bf.header_text, bf.refs)]
    for rec in bf.records:
        out.append(struct.pack("<i", len(rec.data)))
        out.append(bytes(rec.data))
    raw = b"".join(out)
    return bgzf.compress(raw, level) if compress else raw


def rewrite_quals(rec: BamRecord, new_quals_machine: np.ndarray,
                  set_oq: bool = False) -> None:
    """Write recalibrated quals back into the record (machine order in,
    alignment order stored).  Optionally store original quals in OQ."""
    old = rec.quals().astype(np.uint8)
    q = np.asarray(new_quals_machine, dtype=np.uint8)
    if rec.is_reverse:
        q = q[::-1]
    if q.shape[0] != rec.l_seq:
        raise BAMError("qual length mismatch")
    if set_oq:
        _set_zstr_tag(rec, "OQ", bytes((old + 33).astype(np.uint8)))
    rec.data[rec.qual_off:rec.qual_off + rec.l_seq] = q.tobytes()


def build_record(name: str, seq_codes: np.ndarray, quals: np.ndarray,
                 flag: int = 0x4, rg: str | None = None,
                 refid: int = -1, pos: int = -1,
                 cigar=None, aux_extra: bytes = b"") -> BamRecord:
    """Construct a BamRecord from scratch (fixtures / FASTQ->BAM).

    cigar: optional [(op_char, length)] (e.g. [("M", 100)]).
    """
    seq_codes = np.asarray(seq_codes, dtype=np.int64)
    quals = np.asarray(quals, dtype=np.uint8)
    l_seq = int(seq_codes.shape[0])
    nb = CODE_TO_NIBBLE[np.clip(seq_codes, 0, 4)]
    if l_seq % 2:
        nb = np.concatenate([nb, np.zeros(1, np.uint8)])
    packed = ((nb[0::2] << 4) | nb[1::2]).astype(np.uint8).tobytes()
    nameb = name.encode() + b"\x00"
    cigar = cigar or []
    cigarb = b"".join(struct.pack("<I", (ln << 4) | _CIGAR_OP_CODES[op])
                      for op, ln in cigar)
    aux = b""
    if rg is not None:
        aux += b"RGZ" + rg.encode() + b"\x00"
    aux += aux_extra
    body = bytearray()
    body += struct.pack("<iiBBHHHiiii", refid, pos, len(nameb), 0, 0,
                        len(cigar), flag, l_seq, -1, -1, 0)
    body += nameb
    body += cigarb
    body += packed
    body += quals.tobytes()
    body += aux
    name_off = 32
    seq_off = name_off + len(nameb) + len(cigarb)
    qual_off = seq_off + (l_seq + 1) // 2
    aux_off = qual_off + l_seq
    return BamRecord(body, flag, l_seq, name, seq_off, qual_off, aux_off,
                     refid, pos)


def _set_zstr_tag(rec: BamRecord, tag: str, value: bytes) -> None:
    """Add or replace a Z-type aux tag (record body grows/shrinks): the
    first Z-typed `tag` is deleted and the new one appended at the end."""
    d = rec.data
    i = rec.aux_off
    n = len(d)
    tagb = tag.encode()
    while i + 3 <= n:
        t = bytes(d[i:i + 2])
        typ = d[i + 2]
        start = i
        i += 3
        if typ in _AUX_SIZES:
            i += _AUX_SIZES[typ]
        elif typ in (ord("Z"), ord("H")):
            j = i
            while j < n and d[j] != 0:
                j += 1
            i = j + 1
        elif typ == ord("B"):
            sub = d[i]
            cnt = struct.unpack_from("<I", d, i + 1)[0]
            i += 5 + _AUX_SIZES[sub] * cnt
        else:
            raise BAMError(f"unknown aux type {chr(typ)}")
        if t == tagb and typ == ord("Z"):
            del d[start:i]
            break
    d.extend(tagb + b"Z" + value + b"\x00")

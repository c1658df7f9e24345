"""CRAM 3.0 reader: blocks, containers, the compression and slice headers,
the general per-record slice decoder and the container stream.

Counterpart of ``kbbq_tpu/io/cram.py``, the same semantics and errors.
Scope (the JAX package's, both written from the CRAM 3.0 specification):

- block methods: raw, gzip, bzip2, lzma, rANS 4x8 (orders 0/1, the native
  codec of ``csrc/kbbq_io.cc``);
- encodings: EXTERNAL, HUFFMAN (canonical; the 0-bit constant case is
  the common one), BYTE_ARRAY_STOP, BYTE_ARRAY_LEN, BETA;
- sequence reconstruction: reference-based (external FASTA or
  slice-embedded reference) with X/I/D/S/N/P/H/B/b/q/Q features, plus
  verbatim-bases records ('b' features / unmapped BA path) as written
  by no-reference encoders;
- decoded records surface as ``io/bam.py`` BamRecord objects, so the
  BAM machinery (machine order, RG registry, OQ) applies unchanged.

The wholesale decode of the all-EXTERNAL profile is ``io/cram_vec.py``;
``decode_slice`` here is per record, as the format's core-bit codecs are.
"""

from __future__ import annotations

import bz2
import dataclasses
import gzip
import lzma
import struct
import zlib

import numpy as np

from .bam import BamFile, build_record
from .cram_codecs import rans_uncompress, read_itf8, read_ltf8
from .fasta import read_fasta

CRAM_MAGIC = b"CRAM"

# block content types
CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5

# block compression methods
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS = 0, 1, 2, 3, 4


class CRAMError(ValueError):
    pass


def _read_array_itf8(buf, pos):
    n, pos = read_itf8(buf, pos)
    out = []
    for _ in range(n):
        v, pos = read_itf8(buf, pos)
        out.append(v)
    return out, pos


@dataclasses.dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes
    span: tuple = None   # (start, end) byte range within the parse buf


def read_block(buf, pos):
    start = pos
    method = buf[pos]
    ctype = buf[pos + 1]
    pos += 2
    cid, pos = read_itf8(buf, pos)
    csize, pos = read_itf8(buf, pos)
    rsize, pos = read_itf8(buf, pos)
    raw = bytes(buf[pos:pos + csize])
    pos += csize
    if pos + 4 > len(buf):
        raise CRAMError("truncated block")
    # spec: CRC-32 of all preceding bytes of the block — rejects
    # truncation/corruption that the entropy coders would otherwise
    # decode into garbage silently
    want = int.from_bytes(bytes(buf[pos:pos + 4]), "little")
    got = zlib.crc32(bytes(buf[start:pos]))
    if want != got:
        raise CRAMError("block CRC mismatch")
    pos += 4
    if method == M_RAW:
        data = raw
    elif method == M_GZIP:
        data = gzip.decompress(raw)
    elif method == M_BZIP2:
        data = bz2.decompress(raw)
    elif method == M_LZMA:
        data = lzma.decompress(raw)
    elif method == M_RANS:
        data = rans_uncompress(raw, rsize)
    else:
        raise CRAMError(f"unsupported block method {method}")
    if len(data) != rsize:
        raise CRAMError("block raw-size mismatch")
    return Block(method, ctype, cid, data, (start, pos)), pos


@dataclasses.dataclass
class Container:
    length: int
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    bases: int
    n_blocks: int
    landmarks: list
    body_pos: int   # offset of first block


def read_container_header(buf, pos):
    if pos + 4 > len(buf):
        return None, pos
    length = struct.unpack_from("<i", buf, pos)[0]
    pos += 4
    ref_id, pos = read_itf8(buf, pos)
    start, pos = read_itf8(buf, pos)
    span, pos = read_itf8(buf, pos)
    n_rec, pos = read_itf8(buf, pos)
    counter, pos = read_ltf8(buf, pos)
    bases, pos = read_ltf8(buf, pos)
    n_blocks, pos = read_itf8(buf, pos)
    landmarks, pos = _read_array_itf8(buf, pos)
    pos += 4  # header CRC
    return Container(length, ref_id, start, span, n_rec, counter, bases,
                     n_blocks, landmarks, pos), pos


# ----------------------------------------------------------- encodings


class BitReader:
    """MSB-first bit reader over the CORE block."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 0

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self.data[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


def parse_encoding(buf, pos):
    codec, pos = read_itf8(buf, pos)
    plen, pos = read_itf8(buf, pos)
    params = bytes(buf[pos:pos + plen])
    pos += plen
    return (codec, params), pos


class Decoder:
    """One data series' decoder bound to its block cursors."""

    def __init__(self, enc, streams, core: BitReader):
        self.codec, params = enc
        self.core = core
        p = 0
        if self.codec == 1:          # EXTERNAL
            cid, p = read_itf8(params, p)
            # a declared series may have no block in this slice (no
            # record used it) — only an actual read may then fail
            self.stream = streams.get(cid) or Stream(b"")
        elif self.codec == 3:        # HUFFMAN (canonical)
            syms, p = _read_array_itf8(params, p)
            lens, p = _read_array_itf8(params, p)
            self.syms, self.lens = syms, lens
            if len(syms) == 1 and lens[0] == 0:
                self.const = syms[0]
            else:
                self.const = None
                # canonical codes: assigned sorting by (bit length,
                # SYMBOL VALUE) — the CRAM 3.0 / htslib convention.
                # Sorting ties by transmission index instead decodes a
                # wrong table for alphabets not stored in ascending
                # symbol order within a length class.
                order = sorted(range(len(syms)),
                               key=lambda i: (lens[i], syms[i]))
                code = 0
                prev_len = 0
                self.table = {}
                for i in order:
                    code <<= (lens[i] - prev_len)
                    prev_len = lens[i]
                    self.table[(lens[i], code)] = syms[i]
                    code += 1
        elif self.codec == 4:        # BYTE_ARRAY_LEN
            len_enc, p = parse_encoding(params, p)
            val_enc, p = parse_encoding(params, p)
            self.len_dec = Decoder(len_enc, streams, core)
            self.val_dec = Decoder(val_enc, streams, core)
        elif self.codec == 5:        # BYTE_ARRAY_STOP
            self.stop = params[p]
            p += 1
            cid, p = read_itf8(params, p)
            self.stream = streams.get(cid) or Stream(b"")
        elif self.codec == 6:        # BETA
            self.offset, p = read_itf8(params, p)
            self.nbits, p = read_itf8(params, p)
        else:
            raise CRAMError(f"unsupported encoding codec {self.codec}")

    # int value
    def get_int(self) -> int:
        if self.codec == 1:
            v, self.stream.pos = read_itf8(self.stream.data,
                                           self.stream.pos)
            return v
        if self.codec == 3:
            if self.const is not None:
                return self.const
            ln = 0
            code = 0
            while True:
                code = (code << 1) | self.core.read(1)
                ln += 1
                hit = self.table.get((ln, code))
                if hit is not None:
                    return hit
                if ln > 31:
                    raise CRAMError("bad huffman stream")
        if self.codec == 6:
            return self.core.read(self.nbits) - self.offset
        raise CRAMError(f"codec {self.codec} cannot decode ints")

    def get_byte(self) -> int:
        if self.codec == 1:
            b = self.stream.data[self.stream.pos]
            self.stream.pos += 1
            return b
        return self.get_int()

    def get_bytes(self, n: int | None = None) -> bytes:
        if self.codec == 5:
            d = self.stream.data
            j = d.index(bytes([self.stop]), self.stream.pos)
            out = d[self.stream.pos:j]
            self.stream.pos = j + 1
            return out
        if self.codec == 4:
            n2 = self.len_dec.get_int()
            return bytes(self.val_dec.get_byte() for _ in range(n2))
        if self.codec == 1:
            if n is None:
                raise CRAMError("EXTERNAL byte array needs a length")
            out = self.stream.data[self.stream.pos:self.stream.pos + n]
            self.stream.pos += n
            return out
        raise CRAMError(f"codec {self.codec} cannot decode byte arrays")


class Stream:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0


def _parse_map(data, pos, parse_value):
    """CRAM map: byte size, entry count, entries."""
    _size, pos = read_itf8(data, pos)
    count, pos = read_itf8(data, pos)
    out = {}
    for _ in range(count):
        key = bytes(data[pos:pos + 2]).decode()
        pos += 2
        val, pos = parse_value(data, pos, key)
        out[key] = val
    return out, pos


@dataclasses.dataclass
class CompressionHeader:
    rn: bool
    ap_delta: bool
    rr: bool
    sm: bytes
    td: list          # tag dictionary: list of [(tag, type), ...]
    ds: dict          # series key -> encoding
    tags: dict        # tag key int -> encoding


def parse_compression_header(data) -> CompressionHeader:
    pos = 0
    # preservation map
    _size, pos = read_itf8(data, pos)
    count, pos = read_itf8(data, pos)
    rn = ap = rr = True
    sm = bytes(5)
    td: list = [[]]
    for _ in range(count):
        key = bytes(data[pos:pos + 2]).decode()
        pos += 2
        if key in ("RN", "AP", "RR"):
            v = data[pos]
            pos += 1
            if key == "RN":
                rn = bool(v)
            elif key == "AP":
                ap = bool(v)
            else:
                rr = bool(v)
        elif key == "SM":
            sm = bytes(data[pos:pos + 5])
            pos += 5
        elif key == "TD":
            blen, pos = read_itf8(data, pos)
            blob = bytes(data[pos:pos + blen])
            pos += blen
            td = []
            for line in blob.split(b"\x00")[:-1] if blob else [b""]:
                entries = []
                for i in range(0, len(line), 3):
                    entries.append((line[i:i + 2].decode(),
                                    chr(line[i + 2])))
                td.append(entries)
            if not td:
                td = [[]]
        else:
            raise CRAMError(f"unknown preservation key {key}")
    # data series encodings
    def enc_val(d, p, _k):
        return parse_encoding(d, p)
    ds, pos = _parse_map(data, pos, enc_val)
    # tag encodings
    _size, pos = read_itf8(data, pos)
    count, pos = read_itf8(data, pos)
    tags = {}
    for _ in range(count):
        key, pos = read_itf8(data, pos)
        enc, pos = parse_encoding(data, pos)
        tags[key] = enc
    return CompressionHeader(rn, ap, rr, sm, td, ds, tags)


@dataclasses.dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    n_blocks: int
    content_ids: list
    embedded_ref_id: int


def parse_slice_header(data) -> SliceHeader:
    pos = 0
    ref_id, pos = read_itf8(data, pos)
    start, pos = read_itf8(data, pos)
    span, pos = read_itf8(data, pos)
    n_rec, pos = read_itf8(data, pos)
    counter, pos = read_ltf8(data, pos)
    n_blocks, pos = read_itf8(data, pos)
    cids, pos = _read_array_itf8(data, pos)
    emb, pos = read_itf8(data, pos)
    # md5 (16 bytes) + optional tags follow; not needed for decode
    return SliceHeader(ref_id, start, span, n_rec, counter, n_blocks,
                       cids, emb)


# substitution matrix: ref base index (ACGTN) -> 4 candidate bases in
# alphabetical order; SM byte gives each candidate's 2-bit rank
_BASES = b"ACGTN"


def _sub_base(sm: bytes, ref_base: int, code: int) -> int:
    ri = _BASES.index(ref_base) if ref_base in _BASES else 4
    others = [b for b in _BASES if b != _BASES[ri]][:4]
    byte = sm[ri]
    for i, b in enumerate(others):
        if ((byte >> (6 - 2 * i)) & 3) == code:
            return b
    raise CRAMError("bad substitution code")


def decode_slice(comp: CompressionHeader, blocks, container_ref_id,
                 refs: dict | None, ref_names: list,
                 rg_names: list | None = None):
    """Decode one slice's records -> list of BamRecord.  Each carries its
    numeric RG as ``_cram_rg``; with `rg_names` (the header's @RG IDs in
    order) a record whose RG indexes them also gets an RG:Z tag at the end
    of its aux fields, as ``read_cram`` gives it."""
    hdr = parse_slice_header(blocks[0].data)
    core = None
    streams = {}
    embedded = None
    for b in blocks[1:]:
        if b.content_type == CT_CORE:
            core = BitReader(b.data)
        elif b.content_type == CT_EXTERNAL:
            streams[b.content_id] = Stream(b.data)
            if b.content_id == hdr.embedded_ref_id:
                embedded = b.data
    if core is None:
        core = BitReader(b"")

    dec = {}
    for key, enc in comp.ds.items():
        dec[key] = Decoder(enc, streams, core)
    tag_dec = {k: Decoder(e, streams, core) for k, e in comp.tags.items()}

    def D(key):
        d = dec.get(key)
        if d is None:
            raise CRAMError(f"missing data series {key}")
        return d

    records = []
    last_ap = hdr.start
    for _ in range(hdr.n_records):
        bf = D("BF").get_int()
        cf = D("CF").get_int()
        ref_id = hdr.ref_id
        if ref_id == -2:  # multi-ref slice
            ref_id = D("RI").get_int()
        rl = D("RL").get_int()
        ap = D("AP").get_int()
        if comp.ap_delta:
            ap = last_ap + ap
            last_ap = ap
        rg = D("RG").get_int()
        name = (D("RN").get_bytes().decode()
                if comp.rn and "RN" in dec else "")
        if cf & 2:  # detached
            _mf = D("MF").get_int()
            if not comp.rn and "RN" in dec:
                name = D("RN").get_bytes().decode()
            _ns = D("NS").get_int()
            _np = D("NP").get_int()
            _ts = D("TS").get_int()
        elif cf & 4:  # mate downstream
            _nf = D("NF").get_int()
        tl = D("TL").get_int()
        aux_extra = b""
        rg_name = None
        for tag, typ in comp.td[tl] if tl < len(comp.td) else []:
            key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
            val = tag_dec[key].get_bytes()
            if typ == "Z":
                aux_extra += tag.encode() + b"Z" + val + b"\x00"
            else:
                aux_extra += tag.encode() + typ.encode() + val

        seq = np.full(rl, 4, np.int8)   # 2-bit codes, 4 = N
        quals = np.zeros(rl, np.uint8)
        mapped = not (bf & 0x4)
        # CIGAR reconstruction from features (htslib does the same):
        # read positions not claimed by a clip/indel feature are M
        cig: list = []

        def add_op(op, ln):
            if ln <= 0:
                return
            if cig and cig[-1][0] == op:
                cig[-1] = (op, cig[-1][1] + ln)
            else:
                cig.append((op, ln))

        if mapped:
            fn = D("FN").get_int()
            # reference slice for this record
            ref_seq = None
            if embedded is not None:
                ref_seq = (embedded, hdr.start)
            elif refs is not None and 0 <= ref_id < len(ref_names) \
                    and ref_names[ref_id] in refs:
                ref_seq = (refs[ref_names[ref_id]], 1)
            pos_read = 0      # position within read (0-based)
            pos_ref = ap      # 1-based reference position
            base_lut = np.full(256, 4, np.int8)
            for code, ch in enumerate(b"ACGT"):
                base_lut[ch] = code

            def fill_ref(upto_read, at_ref):
                """Copy reference bases into read[pos_read:upto_read)."""
                if upto_read <= pos_read:
                    return
                if ref_seq is None:
                    if comp.rr:
                        raise CRAMError(
                            "reference-based CRAM needs --fasta-ref "
                            "(or an embedded reference)")
                    return  # RR=false: bases not recoverable -> N
                data_, origin = ref_seq
                a = at_ref - origin
                span = upto_read - pos_read
                chunk = data_[a:a + span]
                arr = base_lut[np.frombuffer(chunk, np.uint8)]
                seq[pos_read:pos_read + arr.size] = arr

            feat_pos = 0
            for _f in range(fn):
                fc = chr(D("FC").get_byte())
                fp = D("FP").get_int()
                feat_pos += fp
                tgt = feat_pos - 1   # 0-based read position
                fill_ref(tgt, pos_ref)   # ref bases up to the feature
                add_op("M", tgt - pos_read)
                pos_ref += tgt - pos_read
                pos_read = tgt
                if fc == "X":
                    add_op("M", 1)
                    code = D("BS").get_int()
                    if ref_seq is not None:
                        data_, origin = ref_seq
                        rb = data_[pos_ref - origin]
                        seq[pos_read] = base_lut[_sub_base(
                            comp.sm, rb, code)]
                    elif comp.rr:
                        # an all-featured read never reaches fill_ref
                        # with a nonzero span, so this path must raise
                        # the same missing-reference error fill_ref
                        # does instead of emitting N
                        raise CRAMError(
                            "reference-based CRAM needs --fasta-ref "
                            "(or an embedded reference)")
                    pos_read += 1
                    pos_ref += 1
                elif fc == "B":
                    add_op("M", 1)
                    seq[pos_read] = base_lut[D("BA").get_byte()]
                    quals[pos_read] = D("QS").get_byte()
                    pos_read += 1
                    pos_ref += 1
                elif fc == "b":
                    bb = D("BB").get_bytes()
                    arr = base_lut[np.frombuffer(bb, np.uint8)]
                    add_op("M", arr.size)
                    seq[pos_read:pos_read + arr.size] = arr
                    pos_read += arr.size
                    pos_ref += arr.size
                elif fc == "q":
                    qq = D("QQ").get_bytes()
                    quals[pos_read:pos_read + len(qq)] = \
                        np.frombuffer(qq, np.uint8)
                elif fc == "Q":
                    quals[pos_read] = D("QS").get_byte()
                elif fc == "I":
                    ins = D("IN").get_bytes()
                    arr = base_lut[np.frombuffer(ins, np.uint8)]
                    add_op("I", arr.size)
                    seq[pos_read:pos_read + arr.size] = arr
                    pos_read += arr.size
                elif fc == "S":
                    sc = D("SC").get_bytes()
                    arr = base_lut[np.frombuffer(sc, np.uint8)]
                    add_op("S", arr.size)
                    seq[pos_read:pos_read + arr.size] = arr
                    pos_read += arr.size
                elif fc == "i":
                    add_op("I", 1)
                    seq[pos_read] = base_lut[D("BA").get_byte()]
                    pos_read += 1
                elif fc == "D":
                    dl = D("DL").get_int()
                    add_op("D", dl)
                    pos_ref += dl
                elif fc == "N":
                    rs = D("RS").get_int()
                    add_op("N", rs)
                    pos_ref += rs
                elif fc == "P":
                    add_op("P", D("PD").get_int())
                elif fc == "H":
                    add_op("H", D("HC").get_int())
                else:
                    raise CRAMError(f"unsupported feature code {fc!r}")
            fill_ref(rl, pos_ref)
            add_op("M", rl - pos_read)
            _mq = D("MQ").get_int()
            if cf & 1:
                qs = D("QS").get_bytes(rl)
                quals = np.frombuffer(qs, np.uint8).copy()
        else:
            ba = D("BA").get_bytes(rl)
            lut = np.full(256, 4, np.int8)
            for code, ch in enumerate(b"ACGT"):
                lut[ch] = code
            seq = lut[np.frombuffer(ba, np.uint8)]
            if cf & 1:
                qs = D("QS").get_bytes(rl)
                quals = np.frombuffer(qs, np.uint8).copy()

        rec = build_record(name or f"r{len(records)}", seq,
                           quals.astype(np.uint8), flag=bf,
                           rg=None, refid=ref_id,
                           pos=ap - 1 if mapped else -1,
                           cigar=cig if (mapped and cig) else None,
                           aux_extra=aux_extra)
        rec._cram_rg = rg
        if rg_names is not None and 0 <= rg < len(rg_names):
            rec.data.extend(b"RGZ" + rg_names[rg].encode() + b"\x00")
        records.append(rec)
    return records


def split_slices(blocks):
    """Split a data container's block list (after the compression
    header) into per-slice groups [slice header block + data blocks]."""
    groups = []
    i = 1
    while i < len(blocks):
        if blocks[i].content_type != CT_SLICE_HEADER:
            raise CRAMError("expected slice header block")
        sh = parse_slice_header(blocks[i].data)
        groups.append(blocks[i:i + 1 + sh.n_blocks])
        i += 1 + sh.n_blocks
    return groups


class CramStream:
    """Streaming CRAM 3.0 container reader: O(container) memory.

    Parses the file header + SAM-header container eagerly (header_text,
    rg_names, ref_names available immediately); containers() then
    yields (container, blocks, raw_bytes) per DATA container — raw is
    the container's full on-disk bytes (header + body), consumed by the
    pass-4 QS-block surgery (io/cram_write.py)."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        head = self.f.read(26)
        if head[:4] != CRAM_MAGIC:
            raise CRAMError("missing CRAM magic")
        if head[4] != 3:
            raise CRAMError(
                f"unsupported CRAM major version {head[4]}")
        self.header_text = ""
        self.rg_names: list = []
        self.ref_names: list = []
        cont, blocks, _ = self._next_container()
        if cont is None:
            raise CRAMError("CRAM has no header container")
        data = blocks[0].data
        tlen = struct.unpack_from("<i", data, 0)[0]
        self.header_text = data[4:4 + tlen].decode("utf-8", "replace")
        for line in self.header_text.splitlines():
            if line.startswith("@RG"):
                for fld in line.split("\t")[1:]:
                    if fld.startswith("ID:"):
                        self.rg_names.append(fld[3:])
            if line.startswith("@SQ"):
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SN:"):
                        self.ref_names.append(fld[3:])

    def _next_container(self):
        """(container, blocks, raw) or (None, None, None) at EOF."""
        peek = self.f.read(4096)
        while True:
            if not peek:
                return None, None, None
            try:
                cont, _ = read_container_header(
                    np.frombuffer(peek, np.uint8), 0)
                break
            except IndexError:
                more = self.f.read(65536)
                if not more:
                    raise CRAMError("truncated container header")
                peek += more
        if cont is None:
            return None, None, None
        hdr_len = cont.body_pos
        body = peek[hdr_len:]
        if len(body) < cont.length:
            body += self.f.read(cont.length - len(body))
            if len(body) < cont.length:
                raise CRAMError("truncated container body")
        else:
            # rewind any over-read past this container
            extra = len(body) - cont.length
            if extra:
                self.f.seek(-extra, 1)
                body = body[:cont.length]
        raw = peek[:hdr_len] + body
        if cont.ref_id == -1 and cont.n_records == 0 and \
                cont.n_blocks == 1 and cont.length == 15:
            return None, None, None      # EOF container
        buf = np.frombuffer(body, np.uint8)
        bpos = 0
        blocks = []
        # read exactly n_blocks blocks: the spec permits trailing
        # container padding (htslib reserves header-container slack for
        # in-place updates), which a `while bpos < end` loop would
        # parse as garbage blocks and reject on CRC
        for _ in range(cont.n_blocks):
            b, bpos = read_block(buf, bpos)
            blocks.append(b)
        return cont, blocks, raw

    def _skip_container(self) -> bool:
        """Hop over one data container WITHOUT inflating its blocks:
        header parse + seek(length).  False at the EOF container/EOF.
        Multi-host range iteration (ROADMAP A16) uses this so host h pays O(headers)
        for containers before its range instead of a full decode."""
        peek = self.f.read(4096)
        while True:
            if not peek:
                return False
            try:
                cont, _ = read_container_header(
                    np.frombuffer(peek, np.uint8), 0)
                break
            except IndexError:
                more = self.f.read(65536)
                if not more:
                    raise CRAMError("truncated container header")
                peek += more
        if cont is None:
            return False
        if cont.ref_id == -1 and cont.n_records == 0 and \
                cont.n_blocks == 1 and cont.length == 15:
            return False                 # EOF container
        already = len(peek) - cont.body_pos
        self.f.seek(cont.length - already, 1)
        return True

    def containers(self, skip: int = 0):
        """Yield (container, blocks, raw) per DATA container; the first
        `skip` containers are seeked over without block decode."""
        for _ in range(skip):
            if not self._skip_container():
                return
        while True:
            cont, blocks, raw = self._next_container()
            if cont is None:
                return
            yield cont, blocks, raw

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_cram(path: str, fasta_ref: str | None = None):
    """Parse a CRAM file -> (BamFile, ref_names).  Decoded records are
    BamRecords (RG aux tags materialized from the SAM header's @RG
    order), so downstream BAM machinery applies unchanged."""
    refs = read_fasta(fasta_ref) if fasta_ref else None

    records = []
    with CramStream(path) as cs:
        header_text = cs.header_text
        rg_names = cs.rg_names
        ref_names = cs.ref_names
        for cont, blocks, _raw in cs.containers():
            comp = parse_compression_header(blocks[0].data)
            for group in split_slices(blocks):
                records.extend(decode_slice(comp, group, cont.ref_id, refs,
                                            ref_names, rg_names))
    hdr = header_text or "@HD\tVN:1.6\n"
    # refs list for BamFile: names with unknown lengths (not stored in
    # CRAM header containers; lengths come from the SAM text if present)
    ref_pairs = []
    for line in hdr.splitlines():
        if line.startswith("@SQ"):
            nm, ln = None, 0
            for fld in line.split("\t")[1:]:
                if fld.startswith("SN:"):
                    nm = fld[3:]
                elif fld.startswith("LN:"):
                    ln = int(fld[3:])
            if nm:
                ref_pairs.append((nm, ln))
    return BamFile(hdr, ref_pairs, records), ref_names

"""SAM text codec: parse/emit headered SAM into the same BamFile model.

Counterpart of ``kbbq_tpu/io/sam.py`` (all of it).  htslib's sam_read1
handles SAM text and BAM through one API (SURVEY.md §3.1 C7); this module
gives ``.sam`` inputs the BAM record model, so the whole recalibration path
(machine-order reads, RG registry, OQ tags, qual rewrite) is shared.

Only the QUAL column changes on output; all other columns are re-emitted
from the parsed record, with aux tags round-tripped through the binary
aux encoding.
"""

from __future__ import annotations

import struct

import numpy as np

from .bam import (
    _CIGAR_OP_CODES,
    BAMError,
    BamFile,
    BamRecord,
    CODE_TO_NIBBLE,
)

_CIGAR_OPS = "MIDNSHP=X"

_ENCODE = np.full(256, 4, dtype=np.int8)
for _c, _ch in enumerate(b"ACGT"):
    _ENCODE[_ch] = _c
    _ENCODE[_ch + 32] = _c  # lowercase
_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _parse_cigar_str(s: str):
    if s == "*":
        return []
    out = []
    num = 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            if ch not in _CIGAR_OP_CODES:
                raise BAMError(f"bad CIGAR op {ch!r}")
            out.append((ch, num))
            num = 0
    return out


def _aux_field_to_binary(field: str) -> bytes:
    parts = field.split(":", 2)
    if len(parts) != 3:
        raise BAMError(f"bad aux field {field!r}")
    tag, typ, val = parts
    tb = tag.encode()
    if typ == "A":
        return tb + b"A" + val.encode()[:1]
    if typ == "i":
        return tb + b"i" + struct.pack("<i", int(val))
    if typ == "f":
        return tb + b"f" + struct.pack("<f", float(val))
    if typ in ("Z", "H"):
        return tb + typ.encode() + val.encode() + b"\x00"
    if typ == "B":
        sub = val[0]
        nums = val[1:].lstrip(",").split(",") if len(val) > 1 else []
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
               "I": "I", "f": "f"}[sub]
        conv = float if sub == "f" else int
        body = b"".join(struct.pack("<" + fmt, conv(x)) for x in nums)
        return tb + b"B" + sub.encode() + struct.pack("<I", len(nums)) + body
    raise BAMError(f"unknown SAM aux type {typ!r}")


def _binary_aux_to_fields(rec: BamRecord) -> list[str]:
    out = []
    for tag, (typ, val) in rec.aux_tags().items():
        if typ == "A":
            out.append(f"{tag}:A:{val.decode()}")
        elif typ in ("c", "C", "s", "S", "i", "I"):
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
                   "I": "I"}[typ]
            out.append(f"{tag}:i:{struct.unpack('<' + fmt, val)[0]}")
        elif typ == "f":
            out.append(f"{tag}:f:{struct.unpack('<f', val)[0]:g}")
        elif typ in ("Z", "H"):
            out.append(f"{tag}:{typ}:{val.decode('utf-8', 'replace')}")
        elif typ == "B":
            sub = chr(val[0])
            cnt = struct.unpack_from("<I", val, 1)[0]
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
                   "I": "I", "f": "f"}[sub]
            vals = struct.unpack_from("<" + fmt * cnt, val, 5)
            body = ",".join(f"{v:g}" if sub == "f" else str(v)
                            for v in vals)
            out.append(f"{tag}:B:{sub}" + ("," + body if body else ""))
    return out


def _line_to_record(line: str, ref_index: dict[str, int]) -> BamRecord:
    f = line.rstrip("\n").split("\t")
    if len(f) < 11:
        raise BAMError(f"SAM record has {len(f)} fields (need >= 11)")
    name, flag, rname, pos1, mapq, cigar_s, rnext, pnext1, tlen = \
        f[0], int(f[1]), f[2], int(f[3]), int(f[4]), f[5], f[6], \
        int(f[7]), int(f[8])
    seq_s, qual_s = f[9], f[10]

    refid = -1 if rname == "*" else ref_index.get(rname, -1)
    if rname != "*" and rname not in ref_index:
        raise BAMError(f"SAM record references unknown sequence {rname!r}")
    if rnext == "=":
        nrid = refid
    elif rnext == "*":
        nrid = -1
    else:
        nrid = ref_index.get(rnext, -1)

    if seq_s == "*":
        codes = np.zeros(0, dtype=np.int8)
    else:
        codes = _ENCODE[np.frombuffer(seq_s.encode(), dtype=np.uint8)]
    l_seq = codes.shape[0]
    if qual_s == "*":
        quals = np.full(l_seq, 0xFF, dtype=np.uint8)
    else:
        quals = (np.frombuffer(qual_s.encode(), dtype=np.uint8)
                 .astype(np.int16) - 33).astype(np.uint8)
        if quals.shape[0] != l_seq:
            raise BAMError(f"record {name!r}: SEQ/QUAL length mismatch")

    cigar = _parse_cigar_str(cigar_s)
    cigarb = b"".join(struct.pack("<I", (ln << 4) | _CIGAR_OP_CODES[op])
                      for op, ln in cigar)
    nb = CODE_TO_NIBBLE[np.clip(codes.astype(np.int64), 0, 4)]
    if l_seq % 2:
        nb = np.concatenate([nb, np.zeros(1, np.uint8)])
    packed = ((nb[0::2] << 4) | nb[1::2]).astype(np.uint8).tobytes()
    nameb = name.encode() + b"\x00"
    aux = b"".join(_aux_field_to_binary(x) for x in f[11:])

    body = bytearray()
    body += struct.pack("<iiBBHHHiiii", refid, pos1 - 1, len(nameb),
                        mapq, 0, len(cigar), flag, l_seq, nrid,
                        pnext1 - 1, tlen)
    body += nameb
    body += cigarb
    body += packed
    body += quals.tobytes()
    body += aux
    seq_off = 32 + len(nameb) + len(cigarb)
    qual_off = seq_off + (l_seq + 1) // 2
    aux_off = qual_off + l_seq
    return BamRecord(body, flag, l_seq, name, seq_off, qual_off, aux_off,
                     refid, pos1 - 1)


def parse_sam_text(text: str) -> BamFile:
    header_lines = []
    refs = []
    ref_index: dict[str, int] = {}
    records = []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("@"):
            header_lines.append(line)
            if line.startswith("@SQ"):
                sn, ln = None, 0
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SN:"):
                        sn = fld[3:]
                    elif fld.startswith("LN:"):
                        ln = int(fld[3:])
                if sn is not None:
                    ref_index[sn] = len(refs)
                    refs.append((sn, ln))
            continue
        records.append(_line_to_record(line, ref_index))
    header = "\n".join(header_lines) + ("\n" if header_lines else "")
    return BamFile(header, refs, records)


def read_sam(path: str) -> BamFile:
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as fh:
        return parse_sam_text(fh.read().decode("utf-8", "replace"))


def record_to_sam_line(rec: BamRecord, ref_names: list[str]) -> str:
    (refid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     nrid, npos, tlen) = struct.unpack_from("<iiBBHHHiiii", rec.data, 0)
    cigar_off = 32 + l_read_name
    cig = []
    for i in range(n_cigar):
        v = struct.unpack_from("<I", rec.data, cigar_off + 4 * i)[0]
        cig.append(f"{v >> 4}{_CIGAR_OPS[v & 0xF]}")
    rname = ref_names[refid] if 0 <= refid < len(ref_names) else "*"
    if nrid < 0:
        rnext = "*"
    elif nrid == refid:
        rnext = "="
    else:
        rnext = ref_names[nrid]
    if l_seq:
        seq = bytes(_DECODE[rec.seq_codes()]).decode()
        q = rec.quals().astype(np.int64)
        qual = ("*" if (q == 0xFF).all()
                else bytes((np.clip(q, 0, 93) + 33).astype(np.uint8)
                           ).decode())
    else:
        seq = qual = "*"
    fields = [rec.name, str(flag), rname, str(pos + 1), str(mapq),
              "".join(cig) or "*", rnext, str(npos + 1), str(tlen),
              seq, qual]
    fields.extend(_binary_aux_to_fields(rec))
    return "\t".join(fields)


def serialize_sam(bf: BamFile) -> bytes:
    ref_names = [name for name, _ in bf.refs]
    lines = []
    if bf.header_text:
        lines.append(bf.header_text.rstrip("\n"))
    for rec in bf.records:
        lines.append(record_to_sam_line(rec, ref_names))
    return ("\n".join(lines) + "\n").encode()

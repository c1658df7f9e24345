"""CRAM 3.0 writer.

Counterpart of ``kbbq_tpu/io/cram_write.py``, the same bytes.  Profile
written: multi-ref slices (RI series), one slice per container unless asked
for more, names preserved, verbatim bases (no-reference encoding: one 'b'
feature per mapped record; BA for unmapped) or X substitutions against a
reference, Z-typed aux tags, rANS- and gzip-compressed blocks.  A gzip
block is ``gzip.compress(raw, 1)``, the JAX package's call: it stamps the
current second into its header, so two writes give the same bytes only
under the same clock.  Everything written is within what ``io/cram.py``
decodes.
"""

from __future__ import annotations

import gzip
import struct
import zlib

import numpy as np

from .cram import (CT_EXTERNAL, CRAMError, parse_slice_header,
                   split_slices)
from .cram_codecs import (
    rans_compress_o0,
    rans_compress_o1,
    write_itf8,
    write_ltf8,
)

_EOF_CONTAINER = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001"
    "000100ee63014b")

# content ids
CID = {"BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6, "RN": 7,
       "TL": 8, "FN": 9, "FC": 10, "FP": 11, "BB": 12, "MQ": 13,
       "QS": 14, "BA": 15, "BS": 16}
_TAG_CID0 = 32

_CODE_TO_BASE = np.frombuffer(b"ACGTN", np.uint8)
_BASES_STR = "ACGTN"


def _arr_itf8(values) -> bytes:
    out = write_itf8(len(values))
    for v in values:
        out += write_itf8(v)
    return out


def _encoding_external(cid: int) -> bytes:
    params = write_itf8(cid)
    return write_itf8(1) + write_itf8(len(params)) + params


def _encoding_stop(stop: int, cid: int) -> bytes:
    params = bytes([stop]) + write_itf8(cid)
    return write_itf8(5) + write_itf8(len(params)) + params


def _block(method: int, ctype: int, cid: int, raw: bytes) -> bytes:
    if method == 1:
        data = gzip.compress(raw, 1)
    elif method == 4:
        data = rans_compress_o1(raw) if len(raw) > 1000 else \
            rans_compress_o0(raw)
    else:
        method = 0
        data = raw
    out = bytes([method, ctype]) + write_itf8(cid) \
        + write_itf8(len(data)) + write_itf8(len(raw)) + data
    # spec: CRC-32 of all preceding bytes of the block
    out += struct.pack("<I", zlib.crc32(out))
    return out


def _map(entries: list[bytes], count: int) -> bytes:
    body = write_itf8(count) + b"".join(entries)
    return write_itf8(len(body)) + body


def write_cram(bf, path: str, records_per_container: int = 100000,
               ref: dict | None = None, embed_ref: bool = False,
               records_per_slice: int | None = None) -> None:
    """Write a BamFile's records as CRAM 3.0.

    ref: {refname: bytes} — mapped single-M-segment records whose
    reference is provided are encoded reference-based (X substitution
    features against the slice reference); embed_ref additionally
    stores the reference slice in the container so readers need no
    external FASTA.  Everything else uses verbatim-bases features."""
    out = bytearray()
    out += b"CRAM" + bytes([3, 0]) + bytes(20)

    # --- SAM header container
    htext = bf.header_text.encode()
    hblock = _block(0, 0, 0, struct.pack("<i", len(htext)) + htext)
    out += _container_header(len(hblock), -1, 0, 0, 0, 0, 0, 1, [0])
    out += hblock

    ref_names = [nm for nm, _ in bf.refs]
    recs = bf.records
    for s in range(0, max(len(recs), 1), records_per_container):
        chunk = recs[s:s + records_per_container]
        if not chunk:
            break
        out += _write_container(chunk, s, ref, ref_names, embed_ref,
                                records_per_slice)
    out += _EOF_CONTAINER
    with open(path, "wb") as f:
        f.write(out)


class CramStreamWriter:
    """Incremental CRAM writer: header container up front, then
    containers appended as chunks arrive, EOF container on close: the
    streamed sink of write_cram's profile (O(container) memory).  The
    record counter of a re-encoded container counts only the records
    written by ``write_records``, as the JAX package's writer does.
    ``write_header=False`` / ``write_eof=False`` write a part with no file
    definition and header container / no EOF container: on several hosts
    host 0's part carries the first, the last host's the second, and
    ``cat`` of the parts is one CRAM."""

    def __init__(self, path, header_text: str, ref_names=None,
                 write_header: bool = True, write_eof: bool = True):
        self.f = open(path, "wb") if isinstance(path, (str, bytes)) \
            else path
        self._own = isinstance(path, (str, bytes))
        self.ref_names = list(ref_names or [])
        self.counter = 0
        self._write_eof = write_eof
        if not write_header:
            return
        self.f.write(b"CRAM" + bytes([3, 0]) + bytes(20))
        htext = header_text.encode()
        hblock = _block(0, 0, 0, struct.pack("<i", len(htext)) + htext)
        self.f.write(_container_header(len(hblock), -1, 0, 0, 0, 0, 0,
                                       1, [0]))
        self.f.write(hblock)

    def write_records(self, chunk, ref=None, embed_ref=False):
        """Encode one container of records (write_cram's profile)."""
        if chunk:
            self.f.write(_write_container(chunk, self.counter, ref,
                                          self.ref_names, embed_ref))
            self.counter += len(chunk)

    def write_raw(self, raw: bytes):
        """Pass a pre-built container (e.g. the pass-4 QS surgery's
        output) straight through."""
        self.f.write(raw)

    def close(self):
        if self._write_eof:
            self.f.write(_EOF_CONTAINER)
        if self._own:
            self.f.close()


def rewrite_container_quals(cont, blocks, raw: bytes,
                            new_qs: list) -> bytes:
    """Rebuild one data container with ONLY its QS blocks replaced.

    cont/blocks/raw come from io/cram.py::CramStream (blocks carry
    their compressed byte spans within the container BODY); new_qs is
    one (qs_content_id, stream_bytes) pair per slice — bytes
    uncompressed — or None to keep that slice untouched.  Every other
    block's compressed
    bytes are copied verbatim — names, tags, bases, mate info, and
    their entropy coding survive bit-for-bit; only the QS external
    block is re-encoded (rANS, like io/cram_write.py's writer) and the
    container header's length/landmarks/CRC updated.
    """
    hdr_len = cont.body_pos
    body = raw[hdr_len:]
    groups = split_slices(blocks)
    if len(new_qs) != len(groups):
        raise CRAMError("one QS replacement per slice required")

    out_body = bytearray()
    # the compression header block (first of the body) passes through
    comp_span = blocks[0].span
    out_body += body[comp_span[0]:comp_span[1]]
    landmarks = []
    for group, qs in zip(groups, new_qs):
        landmarks.append(len(out_body))
        sh = parse_slice_header(group[0].data)
        qs_done = False
        for b in group:
            if qs is not None and b.content_type == CT_EXTERNAL \
                    and not qs_done and b.content_id == qs[0]:
                out_body += _block(4, CT_EXTERNAL, b.content_id, qs[1])
                qs_done = True
            else:
                out_body += body[b.span[0]:b.span[1]]
        if qs is not None and not qs_done:
            raise CRAMError("QS block not found for surgery")
        del sh
    hdr = _container_header(len(out_body), cont.ref_id, cont.start,
                            cont.span, cont.n_records, cont.counter,
                            cont.bases, cont.n_blocks, landmarks)
    return hdr + bytes(out_body)


def _container_header(length, ref_id, start, span, n_rec, counter,
                      bases, n_blocks, landmarks) -> bytes:
    body = write_itf8(ref_id) + write_itf8(start) + write_itf8(span) \
        + write_itf8(n_rec) + write_ltf8(counter) + write_ltf8(bases) \
        + write_itf8(n_blocks) + _arr_itf8(landmarks)
    hdr = struct.pack("<i", length) + body
    return hdr + struct.pack("<I", zlib.crc32(hdr))


def _encode_slice(chunk, ref_seq, line_index: dict, tag_lines: list):
    """Per-record data-series streams for ONE slice.

    line_index/tag_lines are CONTAINER-wide mutable state (the TD tag
    dictionary in the compression header covers every slice).  Returns
    (S, tag_streams, bases, ap_min, ap_max)."""
    S = {k: bytearray() for k in CID}
    S["BS"] = bytearray()
    tag_streams: dict = {}

    def put_int(key, v):
        S[key] += write_itf8(v)

    bases = 0
    ap_min, ap_max = None, 0
    for rec in chunk:
        bf_flag = rec.flag
        mapped = not (bf_flag & 0x4)
        rl = rec.l_seq
        bases += rl
        put_int("BF", bf_flag)
        put_int("CF", 1)          # quality scores stored
        put_int("RI", rec.refid if rec.refid is not None else -1)
        put_int("RL", rl)
        put_int("AP", rec.pos + 1 if mapped else 0)
        put_int("RG", getattr(rec, "_rg_index", -1))
        S["RN"] += rec.name.encode() + b"\x00"
        # tag line
        tags = [(t, tv) for t, tv in rec.aux_tags().items()
                if tv[0] == "Z" and t != "RG"]
        key = tuple(t for t, _ in tags)
        tl = line_index.get(key)
        if tl is None:
            tl = line_index[key] = len(tag_lines)
            tag_lines.append(key)
        put_int("TL", tl)
        for t, (typ, val) in tags:
            tkey = (ord(t[0]) << 16) | (ord(t[1]) << 8) | ord("Z")
            st = tag_streams.setdefault(tkey, bytearray())
            st += val + b"\x00"
        codes = rec.seq_codes()
        seq_bytes = _CODE_TO_BASE[np.clip(codes, 0, 4)].tobytes()
        q = rec.quals().astype(np.uint8).tobytes()
        ref_ok = (mapped and ref_seq is not None and rec.pos >= 0
                  and rec.pos + rl <= len(ref_seq))
        if ref_ok:
            # X substitution features vs the reference (single-M
            # shape); N bases can't be expressed as substitutions, so
            # maximal N runs become 'b' verbatim spans interleaved with
            # the X features in read order — the mixed b+ref-fill shape
            # the vectorised decoder must handle
            rseg = np.frombuffer(ref_seq[rec.pos:rec.pos + rl], np.uint8)
            isn = codes == 4
            mism = np.flatnonzero(
                (rseg != np.frombuffer(seq_bytes, np.uint8)) & ~isn)
            pad = np.concatenate([[False], isn, [False]])
            d = np.diff(pad.astype(np.int8))
            nstarts = np.flatnonzero(d == 1)
            nends = np.flatnonzero(d == -1)
            feats = sorted(
                [(int(p), "X", 0) for p in mism]
                + [(int(s), "b", int(e)) for s, e in zip(nstarts, nends)])
            put_int("FN", len(feats))
            last = 0
            for p, kind, e in feats:
                S["FC"] += b"X" if kind == "X" else b"b"
                put_int("FP", p + 1 - last)
                last = p + 1
                if kind == "X":
                    others = [b for b in _BASES_STR
                              if b != chr(rseg[p])][:4]
                    S["BS"] += write_itf8(others.index(chr(seq_bytes[p])))
                else:
                    S["BB"] += seq_bytes[p:e] + b"\x00"
            put_int("MQ", 0)
            S["QS"] += q
            ap_min = rec.pos + 1 if ap_min is None \
                else min(ap_min, rec.pos + 1)
            ap_max = max(ap_max, rec.pos + rl)
        elif mapped:
            put_int("FN", 1)
            S["FC"] += b"b"
            put_int("FP", 1)
            S["BB"] += seq_bytes + b"\x00"
            put_int("MQ", 0)
            S["QS"] += q
        else:
            S["BA"] += seq_bytes
            S["QS"] += q
    return S, tag_streams, bases, ap_min, ap_max


def _write_container(chunk, counter0: int, ref: dict | None = None,
                     ref_names: list | None = None,
                     embed_ref: bool = False,
                     records_per_slice: int | None = None) -> bytes:
    """One data container; records_per_slice splits it into MULTIPLE
    slices sharing the compression header (the htslib
    slices-per-container shape — single-slice when None)."""
    # reference-based encoding applies when the whole chunk maps to ONE
    # reference we hold (a slice carries at most one embedded ref)
    ref_seq = None
    if ref is not None and ref_names:
        ids = {r.refid for r in chunk if not (r.flag & 0x4)}
        if len(ids) == 1:
            (rid,) = ids
            if 0 <= rid < len(ref_names) and ref_names[rid] in ref:
                ref_seq = ref[ref_names[rid]]

    rps = records_per_slice or max(len(chunk), 1)
    subs = [chunk[i:i + rps] for i in range(0, max(len(chunk), 1), rps)]
    line_index: dict = {}
    tag_lines: list = []
    enc = [_encode_slice(s, ref_seq, line_index, tag_lines)
           for s in subs]

    # --- compression header (container-wide: TD spans all slices)
    used_ref = any(bool(e[0]["BS"]) for e in enc) or (
        ref_seq is not None and any(e[3] is not None for e in enc))
    pres = []
    pres.append(b"RN" + bytes([1]))
    pres.append(b"AP" + bytes([0]))
    pres.append(b"RR" + bytes([1 if used_ref else 0]))
    pres.append(b"SM" + bytes([0x1B] * 5))
    td_blob = bytearray()
    for line in tag_lines:
        for t in line:
            td_blob += t.encode() + b"Z"
        td_blob += b"\x00"
    pres.append(b"TD" + write_itf8(len(td_blob)) + bytes(td_blob))
    pres_map = _map(pres, len(pres))

    ds = []
    for key in ("BF", "CF", "RI", "RL", "AP", "RG", "TL", "FN", "FP",
                "MQ", "BS"):
        ds.append(key.encode() + _encoding_external(CID[key]))
    ds.append(b"RN" + _encoding_stop(0, CID["RN"]))
    ds.append(b"FC" + _encoding_external(CID["FC"]))
    ds.append(b"BB" + _encoding_stop(0, CID["BB"]))
    ds.append(b"QS" + _encoding_external(CID["QS"]))
    ds.append(b"BA" + _encoding_external(CID["BA"]))
    ds_map = _map(ds, len(ds))

    tag_cids = {}
    tag_entries = []
    all_tkeys = sorted({tk for e in enc for tk in e[1]})
    for i, tkey in enumerate(all_tkeys):
        cid = _TAG_CID0 + i
        tag_cids[tkey] = cid
        tag_entries.append(write_itf8(tkey) + _encoding_stop(0, cid))
    tag_map = _map(tag_entries, len(tag_entries))

    comp_raw = pres_map + ds_map + tag_map
    comp_block = _block(1, 1, 0, bytes(comp_raw))

    # --- slices (landmarks = slice-header offsets within the body)
    body = bytearray(comp_block)
    landmarks = []
    counter = counter0
    total_blocks = 1
    total_bases = sum(e[2] for e in enc)
    for (S, tag_streams, _sb, ap_min, ap_max), s_chunk in zip(enc, subs):
        ext_blocks = []
        content_ids = []
        for key, cid in CID.items():
            if S[key]:
                ext_blocks.append(_block(4, 4, cid, bytes(S[key])))
                content_ids.append(cid)
        for tkey, st in sorted(tag_streams.items()):
            ext_blocks.append(_block(1, 4, tag_cids[tkey], bytes(st)))
            content_ids.append(tag_cids[tkey])
        emb_id = -1
        slice_start, slice_span = 0, 0
        if used_ref and ap_min is not None:
            slice_start = ap_min
            slice_span = ap_max - ap_min + 1
            if embed_ref:
                emb_id = 99
                seg = ref_seq[slice_start - 1:slice_start - 1
                              + slice_span]
                ext_blocks.append(_block(1, 4, emb_id, bytes(seg)))
                content_ids.append(emb_id)
        core_block = _block(0, 5, 0, b"")

        sh = write_itf8(-2) + write_itf8(slice_start) \
            + write_itf8(slice_span) \
            + write_itf8(len(s_chunk)) + write_ltf8(counter) \
            + write_itf8(1 + len(ext_blocks)) \
            + _arr_itf8(content_ids) + write_itf8(emb_id) + bytes(16)
        landmarks.append(len(body))
        body += _block(0, 2, 0, sh) + core_block + b"".join(ext_blocks)
        counter += len(s_chunk)
        total_blocks += 2 + len(ext_blocks)

    hdr = _container_header(
        len(body), -2, 0, 0, len(chunk), counter0, total_bases,
        total_blocks, landmarks)
    return hdr + bytes(body)

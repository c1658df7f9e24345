"""Vectorised CRAM 3.0 slice decode: the fast path of both CRAM routes.

Counterpart of ``kbbq_tpu/io/cram_vec.py``, the same arrays and the same
conditions for falling back.  The general decoder (``io/cram.py::
decode_slice``) walks records one at a time because CRAM's core-bit codecs
interleave series in one bit stream.  The all-EXTERNAL profile (every data
series in its own block, ints as ITF8, byte arrays as BYTE_ARRAY_STOP) has
no cross-series sequencing: each stream decodes independently and
wholesale.  htslib's default writer and ``io/cram_write.py`` both emit this
shape; slices that use core-bit codecs (BETA, multi-symbol HUFFMAN),
shared content ids, feature codes other than X and b, or a record longer
than the scan's longest primary return None, and the caller takes the
per-record decoder.

- ``itf8_decode_stream``: whole-stream ITF8 decode by pointer doubling
  (value lengths are prefix-coded, so start offsets form a linear chain;
  log2(n) gather rounds give all n starts without a loop per value).
- ``decode_slice_vec``: profile check, per-series wholesale decode and a
  ragged scatter of bases and qualities into padded [n, max_len] arrays,
  machine-order flip included: ``io/bam_vec.py::decode_machine_chunk``'s
  contract, so the windowed engine takes CRAM and BAM alike.
- ``SliceQuals``: the byte ranges of each record's qualities in the QS
  stream, for pass 4's container surgery (``io/cram_write.py::
  rewrite_container_quals``), which swaps only the QS block.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .cram import (CRAMError, CT_CORE, CT_EXTERNAL, parse_encoding,
                   parse_slice_header)
from .cram_codecs import read_itf8

_ITF8_LEN = np.ones(256, np.int64)
_ITF8_LEN[0x80:0xC0] = 2
_ITF8_LEN[0xC0:0xE0] = 3
_ITF8_LEN[0xE0:0xF0] = 4
_ITF8_LEN[0xF0:] = 5


def itf8_decode_stream(data, count: int):
    """Decode `count` concatenated ITF8 values: (values int64 [count],
    end_pos).  The values of cram_codecs.read_itf8 in a loop."""
    if count == 0:
        return np.zeros(0, np.int64), 0
    arr = np.frombuffer(data, np.uint8) if not isinstance(
        data, np.ndarray) else data
    S = arr.size
    lens = _ITF8_LEN[arr]
    # nxt[p] = start of the value after the one starting at p
    nxt = np.minimum(np.arange(S, dtype=np.int64) + lens, S)
    # pointer doubling: hops[k][p] = position after 2^k values from p
    hops = [np.append(nxt, S)]            # index S = "past end" fixpoint
    k = 1
    while (1 << k) <= count:
        h = hops[-1]
        hops.append(h[h])
        k += 1
    idx = np.arange(count, dtype=np.int64)
    starts = np.zeros(count, np.int64)
    for b in range(len(hops)):
        sel = (idx >> b) & 1 == 1
        if sel.any():
            starts[sel] = hops[b][starts[sel]]
    if starts[-1] >= S:
        raise CRAMError("truncated ITF8 stream")
    ln = lens[starts]
    end = int(starts[-1] + ln[-1])

    def byte(j):
        p = starts + j
        return np.where(p < S, arr[np.minimum(p, S - 1)], 0).astype(
            np.int64)

    b0, b1, b2, b3, b4 = (byte(j) for j in range(5))
    v = b0
    v = np.where(ln == 2, ((b0 & 0x7F) << 8) | b1, v)
    v = np.where(ln == 3, ((b0 & 0x3F) << 16) | (b1 << 8) | b2, v)
    v = np.where(ln == 4,
                 ((b0 & 0x1F) << 24) | (b1 << 16) | (b2 << 8) | b3, v)
    v5 = ((b0 & 0x0F) << 28) | (b1 << 20) | (b2 << 12) | (b3 << 4) \
        | (b4 & 0x0F)
    v5 = np.where(v5 & 0x80000000 != 0, v5 - (1 << 32), v5)
    v = np.where(ln == 5, v5, v)
    return v, end


def _ragged_flat_index(rows, targets, lengths, L):
    """Flat [n, L] indices for copying `lengths[i]` items to
    (rows[i], targets[i]...): standard vectorized ragged copy.

    Uniform lengths (every record the same — the overwhelmingly common
    short-read shape) take a 2-temporary broadcast instead of the
    6-temporary repeat/cumsum chain (~4x less memory traffic on the
    hot container decode)."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    n = len(lengths)
    Lg = int(lengths[0])
    if Lg * n == total and (lengths == Lg).all():
        base = rows * L + targets                       # [n]
        return (base[:, None]
                + np.arange(Lg, dtype=np.int64)).ravel()
    seg = np.repeat(np.arange(n), lengths)
    cs = np.cumsum(lengths) - lengths
    within = np.arange(total, dtype=np.int64) - cs[seg]
    return rows[seg] * L + targets[seg] + within


@dataclasses.dataclass
class SliceQuals:
    """Pass-4 surgery sidecar for one slice: where each decoded record's
    quals live in the QS stream (absolute byte offsets), which records
    are primary (rewritten), and their orientation."""
    qs_cid: int                # content id of the QS external block
    qs_len: int                # total QS stream length
    offs: np.ndarray           # int64 [n_prim] offset of each primary
    lens: np.ndarray           # int64 [n_prim] qual run length
    rev: np.ndarray            # bool  [n_prim] machine-order flipped


_BASE_LUT = np.full(256, 4, np.int8)
for _c, _ch in enumerate(b"ACGT"):
    _BASE_LUT[_ch] = _c
_BASES_ARR = np.frombuffer(b"ACGTN", np.uint8)


def _sub_matrix(sm: bytes) -> np.ndarray:
    """[5, 4] uint8: substituted base byte for (ref base idx, BS code).
    As cram.py::_sub_base."""
    out = np.zeros((5, 4), np.uint8)
    for ri in range(5):
        others = [b for b in b"ACGTN" if b != b"ACGTN"[ri]][:4]
        byte = sm[ri]
        for i, b in enumerate(others):
            out[ri, (byte >> (6 - 2 * i)) & 3] = b
    return out


def _series_codec(comp, key):
    enc = comp.ds.get(key)
    return None if enc is None else enc[0]


def _huff_const(comp, key):
    """Constant value of a 0-bit HUFFMAN series, else None."""
    enc = comp.ds.get(key)
    if enc is None:
        return None
    codec, params = enc
    if codec != 3:
        return None
    p = 0
    n, p = read_itf8(params, p)
    if n != 1:
        return None
    sym, p = read_itf8(params, p)
    n2, p = read_itf8(params, p)
    ln, p = read_itf8(params, p)
    return sym if (n2 == 1 and ln == 0) else None


def _ext_cid(comp, key):
    codec, params = comp.ds[key]
    if codec == 1:
        return read_itf8(params, 0)[0]
    if codec == 5:
        return read_itf8(params, 1)[0]
    raise CRAMError("not external")


def _enc_cids(codec, params):
    """Every external content id an encoding reads from (nested
    BYTE_ARRAY_LEN sub-encodings included)."""
    if codec == 1:
        return [read_itf8(params, 0)[0]]
    if codec == 5:
        return [read_itf8(params, 1)[0]]
    if codec == 4:
        le, p = parse_encoding(params, 0)
        ve, _ = parse_encoding(params, p)
        return _enc_cids(*le) + _enc_cids(*ve)
    return []


def _shared_cids(comp) -> set:
    """Content ids referenced by MORE THAN ONE declared series/tag.
    CRAM permits series to share one external block (values interleave
    per record) — a shape only the per-record decoder can follow, so
    the wholesale path refuses any such id."""
    users: dict = {}
    for key, (codec, params) in comp.ds.items():
        for cid in _enc_cids(codec, params):
            users.setdefault(cid, set()).add(("ds", key))
    for tkey, (codec, params) in comp.tags.items():
        for cid in _enc_cids(codec, params):
            users.setdefault(cid, set()).add(("tag", tkey))
    return {cid for cid, u in users.items() if len(u) > 1}


def decode_slice_vec(comp, blocks, refs, ref_names, max_len: int,
                     rg_lut: np.ndarray, use_oq: bool):
    """Vectorized decode of one slice (header block + data blocks).

    Returns (codes, quals, mask, rgs, seconds, lens, prim, squals)
    matching io/bam_vec.py::decode_machine_chunk's contract (prim =
    indices of primary records among the slice's records), plus the
    SliceQuals sidecar — or None when the slice's profile needs the
    general per-record decoder (core-bit codecs, unsupported feature
    codes, detached names with RN preservation off).

    rg_lut: int32 [num_header_rgs + 1] mapping the CRAM numeric RG
    index (+1, so -1 -> slot 0) to the registry's dense id.
    """
    hdr = parse_slice_header(blocks[0].data)
    n = hdr.n_records
    streams: dict = {}
    embedded = None
    for b in blocks[1:]:
        if b.content_type == CT_CORE:
            if len(b.data):
                return None              # core-bit codecs in use
        elif b.content_type == CT_EXTERNAL:
            streams[b.content_id] = b.data
            if b.content_id == hdr.embedded_ref_id:
                embedded = b.data

    # Wholesale decode assumes each consumed series OWNS its external
    # block: reading a cid that any OTHER declared series/tag also
    # writes to would mis-decode interleaved values, so those force
    # the per-record fallback.
    shared = _shared_cids(comp)

    def claim(cid, key):
        if cid in shared:
            raise _Fallback()
        return cid

    def ints(key, count, required=True):
        const = _huff_const(comp, key)
        if const is not None:
            return np.full(count, const, np.int64)
        codec = _series_codec(comp, key)
        if codec != 1:
            if required:
                raise _Fallback()
            return None
        data = streams.get(claim(_ext_cid(comp, key), key), b"")
        vals, _ = itf8_decode_stream(data, count)
        return vals

    def stop_entries(key, count):
        """First `count` NUL-terminated entries of a BYTE_ARRAY_STOP
        series: (flat bytes, lengths)."""
        codec = _series_codec(comp, key)
        if codec != 5:
            raise _Fallback()
        _, params = comp.ds[key]
        stop = params[0]
        cid = claim(read_itf8(params, 1)[0], key)
        data = np.frombuffer(streams.get(cid, b""), np.uint8)
        ends = np.flatnonzero(data == stop)
        if ends.size < count:
            raise CRAMError(f"truncated {key} stream")
        ends = ends[:count]
        starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
        lens_ = ends - starts
        flat_idx = _ragged_flat_index(np.zeros(count, np.int64), starts,
                                      lens_, 0) if count else \
            np.zeros(0, np.int64)
        return (data[flat_idx] if count else np.zeros(0, np.uint8)), \
            lens_.astype(np.int64)

    try:
        bf = ints("BF", n)
        cf = ints("CF", n)
        rl = ints("RL", n)
        ap = ints("AP", n)
        if comp.ap_delta:
            ap = hdr.start + np.cumsum(ap)
        rg = ints("RG", n)
        if hdr.ref_id == -2:
            ri = ints("RI", n)
        else:
            ri = np.full(n, hdr.ref_id, np.int64)
        if (rl > max_len).any():
            # scan_cram sizes max_len over PRIMARY records; a longer
            # secondary/supplementary record is legal — the per-record
            # fallback copies primaries only, so it degrades cleanly
            raise _Fallback()
        mapped = (bf & 0x4) == 0
        nm = int(mapped.sum())
        fn = ints("FN", nm)
        total_feats = int(fn.sum())
        if total_feats:
            if "FC" not in comp.ds or _series_codec(comp, "FC") != 1:
                raise _Fallback()
            fc = np.frombuffer(
                streams.get(claim(_ext_cid(comp, "FC"), "FC"), b""),
                np.uint8)[:total_feats]
            if fc.size < total_feats:
                raise CRAMError("truncated FC stream")
            bad = ~np.isin(fc, np.frombuffer(b"Xb", np.uint8))
            if bad.any():
                raise _Fallback()        # feature codes beyond {X, b}
            fp = ints("FP", total_feats)
            seg = np.repeat(np.arange(nm), fn)
            cs = np.cumsum(fp)
            first = np.cumsum(fn) - fn   # first feature idx per record
            rec_start_cs = cs - fp       # cumsum before this feature
            start_of_seg = rec_start_cs[first[fn > 0]]
            tgt = cs - np.repeat(start_of_seg, fn[fn > 0]) - 1
        else:
            fc = np.zeros(0, np.uint8)
            fp = np.zeros(0, np.int64)
            seg = np.zeros(0, np.int64)
            tgt = np.zeros(0, np.int64)
    except _Fallback:
        return None

    L = max_len
    codes = np.full((n, L), 4, np.int8)
    quals = np.zeros((n, L), np.int8)

    mrows = np.flatnonzero(mapped)
    urows = np.flatnonzero(~mapped)

    # --- unmapped: BA verbatim runs
    if urows.size:
        try:
            ba_cid = claim(_ext_cid(comp, "BA"), "BA")
        except (KeyError, CRAMError, _Fallback):
            return None
        ba = np.frombuffer(streams.get(ba_cid, b""), np.uint8)
        ulens = rl[urows]
        offs = np.cumsum(ulens) - ulens
        if ulens.sum() > ba.size:
            raise CRAMError("truncated BA stream")
        flat = _ragged_flat_index(urows, np.zeros(urows.size, np.int64),
                                  ulens, L)
        codes.reshape(-1)[flat] = _BASE_LUT[
            ba[_ragged_flat_index(np.zeros(urows.size, np.int64), offs,
                                  ulens, 0)]]

    # --- mapped: X/b features over a reference fill (X and b both
    # advance read and reference 1:1, so ref position of read index i
    # is simply ap + i; any indel-shaped code already fell back).
    # Order matters: the ref fill writes each needy record's FULL span,
    # so 'b' spans are painted AFTER it (they'd be clobbered the other
    # way around); X substitutions go last and are disjoint from 'b'
    # spans, so they still read the reference base underneath.
    ref_avail = np.zeros(n, bool)
    if mrows.size:
        is_b = fc == ord("b")
        is_x = fc == ord("X")
        # b span geometry first: lengths decide how much reference
        # each record still needs
        if is_b.any():
            try:
                bflat, blens = stop_entries("BB", int(is_b.sum()))
            except _Fallback:
                return None
            brec = mrows[seg[is_b]]
            btgt = tgt[is_b]
            covered = np.zeros(n, np.int64)
            np.add.at(covered, brec, blens)
            if is_x.any():
                # an X targeting a position INSIDE a b span replays
                # feature-order semantics only the per-record walk has
                bcover = np.zeros(n * L, bool)
                bcover[_ragged_flat_index(brec, btgt, blens, L)] = True
                if bcover[mrows[seg[is_x]] * L + tgt[is_x]].any():
                    return None
        else:
            bflat = np.zeros(0, np.uint8)
            blens = np.zeros(0, np.int64)
            brec = btgt = np.zeros(0, np.int64)
            covered = np.zeros(n, np.int64)
        need_ref = rl[mrows] - covered[mrows]
        if (need_ref > 0).any():
            rrows = mrows[need_ref > 0]
            if embedded is not None:
                ref_arr = np.frombuffer(embedded, np.uint8)
                origin = hdr.start
                # all rows share the slice reference
                rlen = rl[rrows]
                flat = _ragged_flat_index(
                    rrows, np.zeros(rrows.size, np.int64), rlen, L)
                src = _ragged_flat_index(
                    np.zeros(rrows.size, np.int64), ap[rrows] - origin,
                    rlen, 0)
                if src.size and (src.max(initial=0) >= ref_arr.size
                                 or (src < 0).any()):
                    raise CRAMError("embedded reference out of range")
                codes.reshape(-1)[flat] = _BASE_LUT[ref_arr[src]]
                ref_avail[rrows] = True
            elif refs is not None:
                for rid in np.unique(ri[rrows]):
                    rows_r = rrows[ri[rrows] == rid]
                    if not (0 <= rid < len(ref_names)
                            and ref_names[rid] in refs):
                        if comp.rr:
                            raise CRAMError(
                                "reference-based CRAM needs --fasta-ref "
                                "(or an embedded reference)")
                        continue
                    ref_arr = np.frombuffer(refs[ref_names[rid]],
                                            np.uint8)
                    rlen = rl[rows_r]
                    flat = _ragged_flat_index(
                        rows_r, np.zeros(rows_r.size, np.int64), rlen, L)
                    src = _ragged_flat_index(
                        np.zeros(rows_r.size, np.int64), ap[rows_r] - 1,
                        rlen, 0)
                    if src.size and (src.max(initial=0) >= ref_arr.size
                                     or (src < 0).any()):
                        raise CRAMError("reference out of range")
                    codes.reshape(-1)[flat] = _BASE_LUT[ref_arr[src]]
                    ref_avail[rows_r] = True
            elif comp.rr:
                raise CRAMError(
                    "reference-based CRAM needs --fasta-ref "
                    "(or an embedded reference)")
        # b spans paint over the ref fill
        if is_b.any():
            flat = _ragged_flat_index(brec, btgt, blens, L)
            codes.reshape(-1)[flat] = _BASE_LUT[bflat]
        # X substitutions paint over the ref fill — only where a
        # reference was actually available (RR=false files without a
        # reference leave N, like the per-record decoder)
        if is_x.any():
            if "BS" not in comp.ds or _series_codec(comp, "BS") != 1:
                return None
            try:
                bs_cid = claim(_ext_cid(comp, "BS"), "BS")
            except _Fallback:
                return None
            bs = itf8_decode_stream(
                streams.get(bs_cid, b""), int(is_x.sum()))[0]
            xrec = mrows[seg[is_x]]
            xtgt = tgt[is_x]
            xa = ref_avail[xrec]
            if xa.any():
                xrec, xtgt, bs = xrec[xa], xtgt[xa], bs[xa]
                # current codes at those spots hold the REF base
                refb = _BASES_ARR[codes[xrec, xtgt]]
                subm = _sub_matrix(comp.sm)
                # ref base byte -> ACGTN index
                base_idx = np.full(256, 4, np.int64)
                for i, chb in enumerate(b"ACGTN"):
                    base_idx[chb] = i
                codes[xrec, xtgt] = _BASE_LUT[subm[base_idx[refb],
                                                   bs.astype(np.int64)]]

    # --- quals: QS runs for CF&1 records
    has_q = (cf & 1) == 1
    qlens = np.where(has_q, rl, 0)
    qoffs = np.cumsum(qlens) - qlens
    qs_len = int(qlens.sum())
    if qs_len:
        try:
            qs_cid = claim(_ext_cid(comp, "QS"), "QS")
        except (KeyError, CRAMError, _Fallback):
            return None
        qs = np.frombuffer(streams.get(qs_cid, b""), np.uint8)
        if qs.size < qs_len:
            raise CRAMError("truncated QS stream")
        qrows = np.flatnonzero(has_q)
        flat = _ragged_flat_index(qrows, np.zeros(qrows.size, np.int64),
                                  qlens[qrows], L)
        quals.reshape(-1)[flat] = qs[_ragged_flat_index(
            np.zeros(qrows.size, np.int64), qoffs[qrows], qlens[qrows],
            0)].astype(np.int8)
    else:
        try:
            qs_cid = claim(_ext_cid(comp, "QS"), "QS") \
                if "QS" in comp.ds else -1
        except (CRAMError, _Fallback):
            qs_cid = -1

    # --- primary selection + machine order (as io/bam_vec.py)
    prim = np.flatnonzero(((bf & 0x900) == 0) & (rl > 0))
    np_ = prim.size
    lens_out = rl[prim].astype(np.int64)
    seconds = ((bf[prim] & 0x80) != 0)
    rgi = rg[prim] + 1                    # slot 0 = no/unknown RG
    rgi[(rgi < 1) | (rgi >= rg_lut.size)] = 0
    rgs = rg_lut[rgi.astype(np.int64)].astype(np.int32)
    rev = (bf[prim] & 0x10) != 0

    pcodes = codes[prim]
    pquals = quals[prim]
    if use_oq:
        # OQ:Z tag per record: which records carry OQ follows from the
        # TL line; the OQ stream holds entries for exactly those
        try:
            tl = ints("TL", n)
        except _Fallback:
            return None
        okey = (ord("O") << 16) | (ord("Q") << 8) | ord("Z")
        if okey not in comp.tags:
            raise CRAMError("--use-oq: record has no OQ tag")
        line_has = np.array(
            [any(t == "OQ" for t, _ in line) for line in comp.td], bool)
        has_oq = line_has[np.clip(tl, 0, len(comp.td) - 1)]
        codec, params = comp.tags[okey]
        if codec != 5:
            return None
        stop = params[0]
        try:
            cid = claim(read_itf8(params, 1)[0], "tag:OQ")
        except _Fallback:
            return None
        data = np.frombuffer(streams.get(cid, b""), np.uint8)
        ends = np.flatnonzero(data == stop)
        n_oq = int(has_oq.sum())
        if ends.size < n_oq:
            raise CRAMError("truncated OQ stream")
        ends = ends[:n_oq]
        starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
        olens = ends - starts
        if not has_oq[prim].all():
            raise CRAMError("--use-oq: record has no OQ tag")
        # index of each primary record within the OQ-carrying order
        oq_rank = np.cumsum(has_oq) - 1
        pr = oq_rank[prim]
        if (olens[pr] != lens_out).any():
            raise CRAMError("--use-oq: OQ length != read length")
        flat = _ragged_flat_index(np.arange(np_, dtype=np.int64),
                                  np.zeros(np_, np.int64), lens_out, L)
        pquals = np.zeros((np_, L), np.int8)
        pquals.reshape(-1)[flat] = (data[_ragged_flat_index(
            np.zeros(np_, np.int64), starts[pr], lens_out, 0)].astype(
                np.int16) - 33).astype(np.int8)

    # machine-order flip per length group
    out_codes = np.full((np_, L), 4, np.int8)
    out_quals = np.zeros((np_, L), np.int8)
    mask = np.zeros((np_, L), bool)
    for Lg in np.unique(lens_out) if np_ else []:
        sel = np.flatnonzero(lens_out == Lg)
        Lg = int(Lg)
        c = pcodes[sel, :Lg]
        q = pquals[sel, :Lg]
        r = rev[sel]
        cf_ = np.where(c[r] < 4, 3 - c[r], c[r])[:, ::-1]
        c = c.copy()
        c[r] = cf_
        q = q.copy()
        q[r] = q[r, ::-1]
        out_codes[sel, :Lg] = c
        out_quals[sel, :Lg] = np.clip(q, 0, 93)
        mask[sel, :Lg] = True

    squals = SliceQuals(qs_cid, qs_len,
                        qoffs[prim].astype(np.int64),
                        np.where(has_q[prim], lens_out, 0), rev)
    return (out_codes, out_quals, mask, rgs, seconds, lens_out, prim,
            squals)


def scan_slice_vec(comp, blocks):
    """Light scan decode of one slice: (bf, rl, rg) int64 arrays, or
    None when the profile needs the general decoder.  Used by the
    streaming scan pass — only these three series are touched."""
    hdr = parse_slice_header(blocks[0].data)
    n = hdr.n_records
    streams = {}
    for b in blocks[1:]:
        if b.content_type == CT_CORE:
            if len(b.data):
                return None
        elif b.content_type == CT_EXTERNAL:
            streams[b.content_id] = b.data

    shared = _shared_cids(comp)

    def ints(key):
        const = _huff_const(comp, key)
        if const is not None:
            return np.full(n, const, np.int64)
        if _series_codec(comp, key) != 1:
            raise _Fallback()
        cid = _ext_cid(comp, key)
        if cid in shared:
            raise _Fallback()        # series sharing one block
        return itf8_decode_stream(streams.get(cid, b""), n)[0]

    try:
        return ints("BF"), ints("RL"), ints("RG")
    except _Fallback:
        return None


class _Fallback(Exception):
    """Internal: slice profile needs the general per-record decoder."""

"""Whole-chunk vectorised BAM record decoding and quality rewrite.

Counterpart of ``kbbq_tpu/io/bam_vec.py``: a chunk of records (or a whole
file) is decoded over the raw record buffer, never with an object per
record:

- fixed-offset fields (flag, l_seq, ...) and the section offsets of every
  record by the native codec (``kbbq_bam_fields``: one read of each
  record's first 20 bytes, one thread per range of records);
- the variable-length aux chain walked record by record by the native
  codec (``kbbq_bam_aux_scan``) to locate RG and OQ tags, a Z value's end
  found inside its record; a Z value holding the bytes "RGZ" is never
  misread as a tag, because the walk respects field boundaries.  The same
  walk numbers the distinct RG values in order of first appearance;
- sequences and qualities per read-length group by the native codec
  (``kbbq_bam_decode``: nibble table and machine-order flip in one
  threaded pass);
- the pass-4 QUAL write-back by the native codec (``kbbq_bam_write_quals``:
  machine-order rows into alignment order), and with --set-oq the grown
  records by ``kbbq_bam_append_oq``.

Beside each native call is its NumPy body as ``*_plain``, which the tests
hold the codec against.  Records whose aux chain the walk refuses (unknown
type, unterminated Z/H, overrun) take the per-record ``BamRecord`` route,
which keeps the reference's semantics, its error messages included.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.trace import OFF
from . import native_lib
from .bam import BAMError, machine_order_read, record_from_body, rewrite_quals

# aux value sizes for fixed-width types; 0 = not fixed-width
_AUX_FIXED = np.zeros(256, np.int64)
for _t, _s in ((b"A", 1), (b"c", 1), (b"C", 1), (b"s", 2), (b"S", 2),
               (b"i", 4), (b"I", 4), (b"f", 4)):
    _AUX_FIXED[_t[0]] = _s
_AUX_IS_FIXED = _AUX_FIXED > 0

_Z, _H, _B = ord("Z"), ord("H"), ord("B")

# 4-bit nibble -> 2-bit code LUTs for whole-byte decode (hi/lo nibble)
_NIB = np.full(16, 4, dtype=np.int8)
for _code, _v in enumerate((1, 2, 4, 8)):
    _NIB[_v] = _code
BYTE_HI = _NIB[np.arange(256) >> 4]
BYTE_LO = _NIB[np.arange(256) & 0xF]

# rows per step of the plain versions' gathers (bounds the index temporaries)
_PLAIN_ROWS = 65536
# distinct read-group names _unique_rows splits off by compares, not a sort
_FEW_ROWS = 16


def _u32(buf, offs):
    """Little-endian uint32 at each of `offs`, as int64."""
    return (buf[offs].astype(np.int64) | (buf[offs + 1].astype(np.int64) << 8)
            | (buf[offs + 2].astype(np.int64) << 16)
            | (buf[offs + 3].astype(np.int64) << 24))


# the fixed part of a record body that bam_fields reads, little-endian
_HEAD = np.dtype([("refid", "<i4"), ("pos", "<i4"), ("l_rn", "u1"),
                  ("mapq", "u1"), ("bin", "<u2"), ("n_cig", "<u2"),
                  ("flag", "<u2"), ("l_seq", "<i4")])


# bam_fields' keys, in the order of the native codec's rows
_FIELDS = ("refid", "pos", "l_rn", "n_cig", "flag", "l_seq", "seq_off",
           "qual_off", "aux_off")


def bam_fields(buf: np.ndarray, offs: np.ndarray) -> dict:
    """Fixed-offset record fields + derived section offsets (all int64),
    by the native codec.

    Layout per SAM spec §4.2: refID, pos, l_read_name, mapq, bin,
    n_cigar_op, flag, l_seq, next_refID, next_pos, tlen, read_name,
    cigar, seq (4-bit packed), qual, aux.
    """
    return dict(zip(_FIELDS, native_lib.bam_fields(buf, offs)))


def bam_fields_plain(buf: np.ndarray, offs: np.ndarray) -> dict:
    """NumPy version of ``bam_fields``: the same values."""
    offs = np.asarray(offs, np.int64)
    head = np.ascontiguousarray(
        buf[offs[:, None] + np.arange(_HEAD.itemsize)]).view(_HEAD)[:, 0]
    f = {name: head[name].astype(np.int64)
         for name in ("refid", "pos", "l_rn", "n_cig", "flag", "l_seq")}
    f["seq_off"] = offs + 32 + f["l_rn"] + 4 * f["n_cig"]
    f["qual_off"] = f["seq_off"] + (f["l_seq"] + 1) // 2
    f["aux_off"] = f["qual_off"] + f["l_seq"]
    return f


def primary_rows(flag: np.ndarray, l_seq: np.ndarray) -> np.ndarray:
    """Rows recalibrated: neither secondary nor supplementary, l_seq > 0."""
    return np.flatnonzero(((flag & 0x900) == 0) & (l_seq > 0))


def aux_scan(buf: np.ndarray, aux_off: np.ndarray, rec_end: np.ndarray,
             tags: tuple = ("RG", "OQ")) -> tuple[dict, np.ndarray]:
    """Walk every record's aux chain, by the native codec: the result of
    ``aux_scan_plain``."""
    found, odd, _, _ = aux_walk(buf, aux_off, rec_end, tags)
    return found, odd


def aux_walk(buf: np.ndarray, aux_off: np.ndarray, rec_end: np.ndarray,
             tags: tuple):
    """``aux_scan``'s (found, odd), then where RG is among the tags the
    read-group values from the same walk: (rg_index, rg_first), each good
    record's index among the distinct RG values in order of first
    appearance (-1: odd or no RG tag) and the first record of each value
    (its span in found["RG"]); else (None, None)."""
    vs, ve, odd, idx, first = native_lib.bam_aux_scan(buf, aux_off,
                                                      rec_end, tags)
    found = {t: (vs[k], ve[k]) for k, t in enumerate(tags)}
    return found, odd, idx, first


def aux_scan_plain(buf: np.ndarray, aux_off: np.ndarray,
                   rec_end: np.ndarray, tags: tuple = ("RG", "OQ")
                   ) -> tuple[dict, np.ndarray]:
    """Walk every record's aux chain in lockstep (vectorised over records).

    Returns ({tag: (val_start, val_end) int64 arrays, -1 where absent},
    odd) where `odd[i]` marks records whose chain could not be walked
    (unknown type byte, unterminated Z/H, overrun) — those need the
    per-record route.  Only Z-typed values are reported for `tags`
    (RG and OQ are Z by spec).  One NumPy pass per aux FIELD POSITION
    (chains are a handful of tags), not per record.
    """
    n = int(aux_off.shape[0])
    found = {t: (np.full(n, -1, np.int64), np.full(n, -1, np.int64))
             for t in tags}
    odd = np.zeros(n, bool)
    if n == 0:
        return found, odd
    zpos = np.flatnonzero(buf == 0)  # NUL positions, for Z/H termination
    cur = aux_off.astype(np.int64).copy()
    end = rec_end.astype(np.int64)
    # smallest legal tag is 4 bytes (tag2 + type1 + 1-byte value)
    active = cur + 4 <= end
    # any non-empty trailing gap < 4 bytes is malformed
    odd |= (cur != end) & ~active
    tcodes = {t: (ord(t[0]), ord(t[1])) for t in tags}
    for _ in range(4096):  # bound: aux region >= 4 bytes per tag
        idx = np.flatnonzero(active)
        if idx.size == 0:
            break
        c = cur[idx]
        t0, t1, ty = buf[c], buf[c + 1], buf[c + 2]
        v = c + 3
        adv = _AUX_FIXED[ty].copy()
        bad = np.zeros(idx.size, bool)

        isz = (ty == _Z) | (ty == _H)
        if isz.any():
            vi = v[isz]
            zi = np.searchsorted(zpos, vi)
            has = zi < zpos.size
            ze = np.where(has, zpos[np.minimum(zi, zpos.size - 1)],
                          np.int64(buf.size))
            zbad = ~has | (ze >= end[idx[isz]])  # NUL must be in-record
            adv[isz] = ze - vi + 1
            bad[isz] |= zbad
            for t, (tc0, tc1) in tcodes.items():
                m = isz.copy()
                m[isz] &= ~zbad
                m &= (t0 == tc0) & (t1 == tc1) & (ty == _Z)
                m &= found[t][0][idx] < 0  # first occurrence wins
                rows = idx[m]
                if rows.size:
                    found[t][0][rows] = v[m]
                    found[t][1][rows] = (v + (adv - 1))[m]

        isb = ty == _B
        if isb.any():
            vb = v[isb]
            ok = vb + 5 <= end[idx[isb]]
            vbs = np.minimum(vb, buf.size - 5)
            sub = buf[vbs]
            cnt = _u32(buf, vbs + 1)
            adv[isb] = 5 + _AUX_FIXED[sub] * cnt
            bad[isb] |= ~ok | ~_AUX_IS_FIXED[sub]

        unknown = ~(_AUX_IS_FIXED[ty] | isz | isb)
        bad |= unknown

        nxt = v + adv
        bad |= nxt > end[idx]
        odd[idx[bad]] = True
        cur[idx] = nxt
        nact = ~bad & (nxt + 4 <= end[idx])
        # clean termination = nxt == end; anything else short is odd
        odd[idx[~bad & ~nact & (nxt != end[idx])]] = True
        # once every wanted tag is located for a record the rest of its
        # chain is irrelevant: with RG first the walk is ONE step
        allfound = np.ones(idx.size, bool)
        for t in tags:
            allfound &= found[t][0][idx] >= 0
        active[idx] = nact & ~allfound
    else:
        odd[active] = True
    return found, odd


def _gather_short(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray
                  ) -> np.ndarray:
    """[n, max_len] zero-padded gather of short variable-length spans
    (RG names).  Missing spans (start<0) become all-zero rows."""
    n = starts.size
    ln = np.maximum(ends - starts, 0)
    ml = int(ln.max(initial=0))
    if ml == 0:
        return np.zeros((n, 1), np.uint8)
    base = np.where(starts < 0, 0, starts)
    idx = np.minimum(base[:, None] + np.arange(ml, dtype=np.int64),
                     buf.size - 1)
    out = buf[idx]
    out[np.arange(ml)[None, :] >= ln[:, None]] = 0
    return out


def _unique_rows(pad: np.ndarray):
    """(uniq_rows, first_idx, inverse) for a [n, m] uint8 array, rows in no
    particular order.  Each zero-padded row is viewed as a few uint64
    words; up to _FEW_ROWS distinct rows (a file has a handful of read
    groups) are split off one at a time by vector compares, more by one
    sort."""
    n, m = pad.shape
    if n == 0:
        return pad, np.zeros(0, np.int64), np.zeros(0, np.int64)
    w = -(-m // 8) * 8
    if w > m:
        pad = np.concatenate(
            [pad, np.zeros((n, w - m), np.uint8)], axis=1)
    words = np.ascontiguousarray(pad).view("<u8")
    inv = np.full(n, -1, np.int64)
    first = []
    rest = np.arange(n)
    while rest.size and len(first) < _FEW_ROWS:
        i = int(rest[0])
        same = (words[rest] == words[i]).all(axis=1)
        inv[rest[same]] = len(first)
        first.append(i)
        rest = rest[~same]
    if rest.size:
        rec = words.view([(f"f{i}", "<u8") for i in range(w // 8)])
        _, first, inv = np.unique(rec.reshape(-1), return_index=True,
                                  return_inverse=True)
    first = np.asarray(first, np.int64)
    return pad[first][:, :m], first, inv.reshape(-1).astype(np.int64)


def _name(row: np.ndarray) -> str:
    return bytes(row[row != 0]).decode()


def _span_name(buf: np.ndarray, s, e) -> str:
    return bytes(buf[int(s):int(e)]).decode()


def rg_ids(buf: np.ndarray, vs: np.ndarray, ve: np.ndarray,
           rg_index: np.ndarray, rg_first: np.ndarray,
           registry: dict) -> np.ndarray:
    """Dense RG index per record from ``aux_walk``'s read-group values
    (rg_index for the records wanted, rg_first and the RG spans vs, ve of
    the whole walk), mapped through the scan-built {name: id} registry
    (missing tag -> "")."""
    lut = [registry[_span_name(buf, vs[r], ve[r])] for r in rg_first]
    if (rg_index < 0).any():
        lut.append(registry[""])        # index -1: the last entry
    return np.asarray(lut, np.int32)[rg_index]


def rg_ids_plain(buf: np.ndarray, vs: np.ndarray, ve: np.ndarray,
                 registry: dict) -> np.ndarray:
    """NumPy version of ``rg_ids`` from the RG spans of the records
    wanted: the same ids."""
    uniq, _, inv = _unique_rows(_gather_short(buf, vs, ve))
    # decode each unique row once (a handful per file)
    lut = np.asarray([registry[_name(row)] for row in uniq], np.int32)
    return lut[inv]


def decode_group(buf, seq_off, qual_off, rev, L: int, use_oq: bool,
                 codes: np.ndarray, quals: np.ndarray) -> None:
    """Machine-order codes and qualities of records of one length L into
    the first L columns of codes and quals (int8 [n, >= L]), by the native
    codec."""
    native_lib.bam_decode(buf, seq_off, qual_off, rev, L, use_oq, codes,
                          quals)


def decode_group_plain(buf, seq_off, qual_off, rev, L: int, use_oq: bool,
                       codes: np.ndarray, quals: np.ndarray) -> None:
    """NumPy version of ``decode_group``: the same bytes."""
    nb = (L + 1) // 2
    rev = np.asarray(rev, bool)
    for s in range(0, len(seq_off), _PLAIN_ROWS):
        e = min(len(seq_off), s + _PLAIN_ROWS)
        packed = buf[np.asarray(seq_off[s:e], np.int64)[:, None]
                     + np.arange(nb)]
        seq = np.empty((e - s, 2 * nb), np.int8)
        seq[:, 0::2] = BYTE_HI[packed]
        seq[:, 1::2] = BYTE_LO[packed]
        seq = seq[:, :L]
        q = buf[np.asarray(qual_off[s:e], np.int64)[:, None]
                + np.arange(L)].astype(np.int16)
        if use_oq:
            q -= 33
        r = rev[s:e]
        if r.any():
            sr = seq[r]
            seq[r] = np.where(sr < 4, 3 - sr, sr)[:, ::-1]
            q[r] = q[r][:, ::-1]
        codes[s:e, :L] = seq
        quals[s:e, :L] = np.clip(q, 0, 93).astype(np.int8)


def decode_machine_chunk(buf: np.ndarray, offs: np.ndarray,
                         sizes: np.ndarray, max_len: int,
                         registry: dict | None, use_oq: bool = False,
                         trace=OFF):
    """(codes, quals, mask, rgs, seconds, lens, prim_rows) for the chunk's
    PRIMARY records, machine order, padded to max_len.

    Matches the per-record path bit for bit: reverse-strand reads are
    reverse-complemented with reversed quals (DECISIONS.md D8), quals
    clipped to [0, 93], --use-oq takes quals from the OQ:Z: tag (error
    if absent).  registry maps RG-tag name -> dense id ("" = untagged).
    `trace` (``utils/trace.py``) counts the primary records the aux walk
    refused, which take the per-record route (``bam.walk_refused``).
    """
    f = bam_fields(buf, offs)
    flag, l_seq = f["flag"], f["l_seq"]
    prim_rows = primary_rows(flag, l_seq)
    n = prim_rows.size
    L = max_len
    codes = np.full((n, L), 4, np.int8)
    quals = np.zeros((n, L), np.int8)
    mask = np.zeros((n, L), bool)
    rgs = np.zeros(n, np.int32)
    seconds = np.zeros(n, bool)
    lens = np.zeros(n, np.int64)
    if n == 0:
        return codes, quals, mask, rgs, seconds, lens, prim_rows

    p_off = offs[prim_rows]
    p_end = p_off + sizes[prim_rows]
    p_seq = f["seq_off"][prim_rows]
    p_len = l_seq[prim_rows]
    p_flag = flag[prim_rows]
    lens[:] = p_len
    seconds[:] = (p_flag & 0x80) != 0
    rev = (p_flag & 0x10) != 0

    want = ("RG", "OQ") if use_oq else ("RG",)
    found, odd, rg_index, rg_first = aux_walk(buf, f["aux_off"][prim_rows],
                                              p_end, want)
    good = np.flatnonzero(~odd)
    trace.count("bam.walk_refused", n - good.size)
    if registry is not None and good.size:
        vs, ve = found["RG"]
        rgs[good] = rg_ids(buf, vs, ve, rg_index[good], rg_first, registry)

    oq_vs = oq_ve = None
    if use_oq:
        oq_vs, oq_ve = found["OQ"]
        missing = good[oq_vs[good] < 0]
        if missing.size:
            r = record_from_body(bytearray(bytes(
                buf[p_off[missing[0]]:p_end[missing[0]]])))
            raise BAMError(f"--use-oq: record {r.name} has no OQ tag")
        if (good.size and
                ((oq_ve[good] - oq_vs[good]) != p_len[good]).any()):
            raise BAMError("--use-oq: OQ length != read length")

    qsrc = oq_vs if use_oq else f["qual_off"][prim_rows]
    for Lg in np.unique(p_len[good]):
        Lg = int(Lg)
        if good.size == n and Lg == L and (p_len == Lg).all():
            # one length, every record: decode straight into the outputs
            decode_group(buf, p_seq, qsrc, rev, Lg, use_oq, codes, quals)
            mask[:] = True
            break
        sel = good[p_len[good] == Lg]
        tmp_c = np.empty((sel.size, Lg), np.int8)
        tmp_q = np.empty((sel.size, Lg), np.int8)
        decode_group(buf, p_seq[sel], qsrc[sel], rev[sel], Lg, use_oq,
                     tmp_c, tmp_q)
        codes[sel, :Lg] = tmp_c
        quals[sel, :Lg] = tmp_q
        mask[sel, :Lg] = True

    # the per-record route: records the vectorised aux walk refused
    for i in np.flatnonzero(odd):
        rec = record_from_body(bytearray(bytes(buf[p_off[i]:p_end[i]])))
        c, q = machine_order_read(rec, use_oq=use_oq)
        m = len(c)
        codes[i, :m] = c
        quals[i, :m] = np.clip(q, 0, 93)
        mask[i, :m] = True
        if registry is not None:
            tag = rec.get_zstr("RG")
            rgs[i] = registry[tag.decode() if tag is not None else ""]
    return codes, quals, mask, rgs, seconds, lens, prim_rows


def write_quals(wbuf: np.ndarray, qual_off, lens, rev,
                new_q_machine: np.ndarray) -> None:
    """Machine-order rows into the QUAL fields of `wbuf`, in place, reversed
    for reverse-strand records, by the native codec."""
    native_lib.bam_write_quals(wbuf, qual_off, lens, rev, new_q_machine)


def write_quals_plain(wbuf: np.ndarray, qual_off, lens, rev,
                      new_q_machine: np.ndarray) -> None:
    """NumPy version of ``write_quals``: the same bytes."""
    lens = np.asarray(lens, np.int64)
    rev = np.asarray(rev, bool)
    for Lg in np.unique(lens):
        Lg = int(Lg)
        sel = np.flatnonzero(lens == Lg)
        for s in range(0, sel.size, _PLAIN_ROWS):
            rows = sel[s:s + _PLAIN_ROWS]
            q = np.ascontiguousarray(new_q_machine[rows, :Lg])
            r = rev[rows]
            if r.any():
                q[r] = q[r][:, ::-1]
            wbuf[np.asarray(qual_off, np.int64)[rows][:, None]
                 + np.arange(Lg)] = q


def append_oq(wbuf: np.ndarray, buf: np.ndarray, offs: np.ndarray,
              sizes: np.ndarray, prim_rows: np.ndarray, qoff: np.ndarray,
              lens: np.ndarray) -> np.ndarray:
    """Every record of the chunk back to back, each primary one followed by
    an OQ:Z tag holding its ORIGINAL qualities (+33, from `buf`), by the
    native codec."""
    oq_len = np.full(offs.size, -1, np.int64)
    oq_len[prim_rows] = lens
    qual = np.zeros(offs.size, np.int64)
    qual[prim_rows] = qoff
    return native_lib.bam_append_oq(wbuf, buf, offs, sizes, qual, oq_len)


def append_oq_plain(wbuf: np.ndarray, buf: np.ndarray, offs: np.ndarray,
                    sizes: np.ndarray, prim_rows: np.ndarray,
                    qoff: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """NumPy version of ``append_oq``: the same bytes (the reference's
    fixed-size reshape where every record is a primary one of one size,
    else its grown-record assembly)."""
    n = offs.size
    uniform = (n and prim_rows.size == n
               and (sizes == sizes[0]).all()
               and (lens == lens[0]).all()
               and ((qoff - offs) == (qoff[0] - offs[0])).all()
               # records packed back to back from offset 0
               and (offs == 4 + np.arange(n, dtype=np.int64)
                    * (int(sizes[0]) + 4)).all())
    if uniform:
        rec = int(sizes[0]) + 4
        L = int(lens[0])
        qo_rel = int(qoff[0] - offs[0]) + 4
        out2 = np.empty((n, rec + L + 4), np.uint8)
        out2[:, :rec] = wbuf[:n * rec].reshape(n, rec)
        out2[:, :4] = np.frombuffer(struct.pack("<i", rec - 4 + L + 4),
                                    np.uint8)
        out2[:, rec:rec + 3] = np.frombuffer(b"OQZ", np.uint8)
        out2[:, rec + 3:rec + 3 + L] = \
            buf[:n * rec].reshape(n, rec)[:, qo_rel:qo_rel + L] \
            + np.uint8(33)
        out2[:, -1] = 0
        return out2.reshape(-1)
    grow = np.zeros(n, np.int64)
    grow[prim_rows] = lens + 4          # "OQZ" + quals + NUL
    seg_old = sizes + 4
    out_len = seg_old + grow
    dst = np.concatenate([[0], np.cumsum(out_len)[:-1]]).astype(np.int64)
    out = np.empty(int(out_len.sum()), np.uint8)
    # old bytes: concatenated-segment copy via the repeat trick
    cso = np.cumsum(seg_old)
    within = np.arange(int(cso[-1])) - np.repeat(cso - seg_old, seg_old)
    out[np.repeat(dst, seg_old) + within] = \
        wbuf[np.repeat(offs - 4, seg_old) + within]
    pd = dst[prim_rows]
    newsz = (sizes[prim_rows] + grow[prim_rows]).astype("<i4")
    out[pd[:, None] + np.arange(4)] = newsz.view(np.uint8).reshape(-1, 4)
    tag0 = pd + seg_old[prim_rows]
    out[tag0], out[tag0 + 1], out[tag0 + 2] = 79, 81, 90  # "OQZ"
    cs = np.cumsum(lens)
    pos = np.arange(int(cs[-1])) - np.repeat(cs - lens, lens)
    # ORIGINAL quals (+33) from the untouched input buffer
    out[np.repeat(tag0 + 3, lens) + pos] = \
        buf[np.repeat(qoff, lens) + pos] + np.uint8(33)
    out[tag0 + 3 + lens] = 0
    return out


def rewrite_quals_chunk(buf: np.ndarray, offs: np.ndarray,
                        sizes: np.ndarray, prim_rows: np.ndarray,
                        lens: np.ndarray, new_q_machine: np.ndarray,
                        set_oq: bool = False):
    """Chunk-level pass-4 rewrite: returns output record bytes for the
    WHOLE chunk (block-size prefixes included, non-primary records
    verbatim) with primary QUAL fields replaced by `new_q_machine`
    (padded [n_prim, max_len] int8, machine order; flipped back to
    alignment order for reverse-strand records here).  `offs` index `buf`,
    whose records lie back to back (a raw chunk, or a file's alignment
    section).

    set_oq has the per-record semantics exactly (io/bam.py::rewrite_quals):
    any existing OQ:Z: tag is removed and a fresh one holding the ORIGINAL
    quals (+33) is appended at the end of the aux region.  Where no record
    has an OQ tag and the aux walk refused none, every record grows by the
    same rule (``append_oq``); otherwise the records are assembled one by
    one.
    """
    pf = bam_fields(buf, offs)
    qoff = pf["qual_off"][prim_rows]
    rev = (pf["flag"][prim_rows] & 0x10) != 0
    wbuf = buf.copy()
    write_quals(wbuf, qoff, lens, rev, new_q_machine)
    if not set_oq or prim_rows.size == 0:
        return wbuf

    p_end = offs[prim_rows] + sizes[prim_rows]
    found, odd = aux_scan(buf, pf["aux_off"][prim_rows], p_end, ("OQ",))
    vs, ve = found["OQ"]
    if not odd.any() and not (vs >= 0).any():
        return append_oq(wbuf, buf, offs, sizes, prim_rows, qoff, lens)

    # delete-existing + append-at-end OQ, record by record
    prim_of = {int(r): j for j, r in enumerate(prim_rows)}
    out = bytearray()
    for i in range(offs.size):
        o, sz = int(offs[i]), int(sizes[i])
        j = prim_of.get(i)
        if j is None:
            out += wbuf[o - 4:o + sz].tobytes()
            continue
        L = int(lens[j])
        if odd[j]:
            rec = record_from_body(bytearray(bytes(buf[o:o + sz])))
            rewrite_quals(rec, np.asarray(new_q_machine[j, :L], np.uint8),
                          set_oq=True)
            out += struct.pack("<i", len(rec.data)) + bytes(rec.data)
            continue
        oldq = (buf[qoff[j]:qoff[j] + L] + np.uint8(33)).tobytes()
        if vs[j] >= 0:
            ts, te = int(vs[j]) - 3, int(ve[j]) + 1  # tag start..NUL
            body = (wbuf[o:ts].tobytes() + wbuf[te:o + sz].tobytes())
        else:
            body = wbuf[o:o + sz].tobytes()
        body += b"OQZ" + oldq + b"\x00"
        out += struct.pack("<i", len(body)) + body
    return out


def scan_chunk(buf: np.ndarray, offs: np.ndarray, sizes: np.ndarray,
               k: int):
    """Metadata for one chunk: (n_primary, bases, kmers, max_len,
    rg_keys_in_first_appearance_order) — the vectorised twin of the
    per-record scan loop.  Appearance order is exact even when some
    records need the per-record route: each distinct good RG value (and
    a missing tag, as "") contributes a first-seen event at its first
    row, each odd row its own event, and the merged event order decides
    registration order.
    """
    f = bam_fields(buf, offs)
    flag, l_seq = f["flag"], f["l_seq"]
    prim = primary_rows(flag, l_seq)
    if prim.size == 0:
        return 0, 0, 0, 1, []
    pl = l_seq[prim]
    p_end = offs[prim] + sizes[prim]
    found, odd, rg_index, rg_first = aux_walk(buf, f["aux_off"][prim], p_end,
                                              ("RG",))
    vs, ve = found["RG"]
    # (first prim-row with this name, name); a good row without the tag
    # reads as ""
    events = [(int(r), _span_name(buf, vs[r], ve[r])) for r in rg_first]
    untagged = np.flatnonzero((rg_index < 0) & ~odd)
    if untagged.size:
        events.append((int(untagged[0]), ""))
    for i in np.flatnonzero(odd):
        rec = record_from_body(bytearray(bytes(
            buf[offs[prim[i]]:p_end[i]])))
        tag = rec.get_zstr("RG")
        events.append((int(i), tag.decode() if tag is not None else ""))
    events.sort()
    keys, seen = [], set()
    for _, nm in events:
        if nm not in seen:
            seen.add(nm)
            keys.append(nm)
    return (int(prim.size), int(pl.sum()),
            int(np.maximum(pl - k + 1, 0).sum()), int(pl.max(initial=1)),
            keys)

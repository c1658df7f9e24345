"""`kbbq-tpu benchmark`: measure ACTUAL per-quality error rates.

Counterpart of ``kbbq_tpu/benchmark.py`` (host NumPy code, the same TSV
bytes): walk an aligned BAM or CRAM against the reference FASTA; a
mismatching aligned base at a position NOT in the variable-sites VCF is a
true error; emit a TSV `label  reportedQ  actualQ  count` where
actualQ = -10*log10((errors+1)/(total+2)) (Yates-smoothed).

Soft-clipped bases and variable sites are excluded; optionally score the
qualities from a recalibrated FASTQ (matched by read name) instead of the
BAM's QUAL field.  ``read_fasta`` is ``io/fasta.py``'s.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from .constants import NUM_Q
from .io.fasta import read_fasta


def _parse_vcf_block(arr: np.ndarray, out: dict) -> None:
    """Columnar parse of one newline-terminated block of VCF text into
    out[chrom] position-array lists (0-based, REF spans expanded)."""
    nl = np.flatnonzero(arr == 10)
    if nl.size == 0:
        return
    ls = np.concatenate([np.zeros(1, np.int64), nl[:-1] + 1])
    le = nl
    first = arr[np.minimum(ls, arr.size - 1)]
    keep = (le > ls) & (first != ord("#"))
    ls, le = ls[keep], le[keep]
    if ls.size == 0:
        return
    tabs = np.flatnonzero(arr == 9)
    fi = np.searchsorted(tabs, ls)
    nt = np.searchsorted(tabs, le) - fi
    ok = nt >= 1                     # need at least CHROM <tab> POS
    ls, le, fi, nt = ls[ok], le[ok], fi[ok], nt[ok]
    if ls.size == 0:
        return
    tt = lambda j: tabs[np.minimum(fi + j, max(tabs.size - 1, 0))]
    t1 = tt(0)
    t2 = np.where(nt >= 2, tt(1), le)
    # POS: vectorized digit parse of [t1+1, t2) (1-based in the file)
    w = t2 - t1 - 1
    maxw = int(w.max(initial=0))
    if maxw == 0:
        return
    d_idx = t2[:, None] - 1 - np.arange(maxw, dtype=np.int64)[None, :]
    dig = arr[np.clip(d_idx, 0, arr.size - 1)].astype(np.int64) - 48
    in_w = np.arange(maxw)[None, :] < w[:, None]
    is_dig = in_w & (dig >= 0) & (dig <= 9)
    pos0 = (np.where(is_dig, dig, 0)
            * 10 ** np.arange(maxw, dtype=np.int64)).sum(1) - 1
    good = (w >= 1) & (is_dig.sum(1) == w)   # drop malformed POS fields
    # REF allele span: field 3 is [t3+1, t4) (or to line end)
    t3, t4 = tt(2), tt(3)
    ref_end = np.where(nt >= 4, t4, le)
    ref_len = np.where(nt >= 3, ref_end - t3 - 1, 1)
    ref_len = np.maximum(ref_len, 1)
    ls, t1 = ls[good], t1[good]
    pos0, ref_len = pos0[good], ref_len[good]
    n = ls.size
    if n == 0:
        return
    # chrom run grouping: sorted VCFs have few runs per block; compare
    # each line's CHROM bytes to the previous line's, vectorized
    clen = t1 - ls
    maxc = int(clen.max(initial=1))
    cb = arr[np.clip(ls[:, None] + np.arange(maxc)[None, :],
                     0, arr.size - 1)]
    cb = np.where(np.arange(maxc)[None, :] < clen[:, None], cb, 0)
    same = np.zeros(n, bool)
    if n > 1:
        same[1:] = (clen[1:] == clen[:-1]) & (cb[1:] == cb[:-1]).all(1)
    gstarts = np.flatnonzero(~same)
    gends = np.concatenate([gstarts[1:], np.asarray([n])])
    for s, e in zip(gstarts, gends):
        chrom = arr[ls[s]:t1[s]].tobytes().decode()
        p = pos0[s:e]
        rl = ref_len[s:e]
        if (rl == 1).all():
            out.setdefault(chrom, []).append(p.copy())
        else:
            rep = np.repeat(p, rl)
            off = (np.arange(rep.size, dtype=np.int64)
                   - np.repeat(np.cumsum(rl) - rl, rl))
            out.setdefault(chrom, []).append(rep + off)


def read_vcf_sites(path: str, block_bytes: int = 32 << 20) -> dict:
    """chrom -> sorted unique int64 array of 0-based variable positions.

    Chunked columnar parse (np.frombuffer newline/tab scan, vectorized
    POS digit parse, run-length CHROM grouping): dbSNP-scale VCFs
    (~1e8 sites) parse at hundreds of MB/s with O(block) parse memory,
    where a per-line Python loop with per-REF-base list appends needs
    hours and tens of GB.  Indel REF alleles cover every REF position.
    Lines with a malformed POS field are skipped.
    """
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    out: dict[str, list] = {}
    carry = b""
    with op(path, "rb") as f:
        while True:
            block = f.read(block_bytes)
            if not block:
                break
            data = carry + block
            last_nl = data.rfind(b"\n")
            if last_nl < 0:
                carry = data
                continue
            carry = data[last_nl + 1:]
            _parse_vcf_block(
                np.frombuffer(data, np.uint8, count=last_nl + 1), out)
    if carry.strip():
        _parse_vcf_block(np.frombuffer(carry + b"\n", np.uint8), out)
    return {c: np.unique(np.concatenate(parts))
            for c, parts in out.items()}


def _strip_pair_suffix(name: str) -> str:
    """Drop a literal trailing '/1' or '/2' pair suffix (and nothing else).

    str.rstrip("/12") is a character-set strip — it collapsed 'read1' and
    'read11' to the same key and mangled 'sample_001'; only the exact
    two-character suffix may be removed.
    """
    if name.endswith("/1") or name.endswith("/2"):
        return name[:-2]
    return name


_CIGAR_OPS = "MIDNSHP=X"


def parse_cigar(data, off, n_cigar):
    """[(op_char, length)] from packed BAM cigar."""
    import struct
    out = []
    for i in range(n_cigar):
        v = struct.unpack_from("<I", data, off + 4 * i)[0]
        out.append((_CIGAR_OPS[v & 0xF], v >> 4))
    return out


def _cram_record_chunks(path: str, refs: dict):
    """CRAM as container-at-a-time raw BAM record chunks: (ref_names,
    generator of (buf, offs, sizes)) matching iter_bam_raw_chunks'
    contract — O(container) memory, no temp BAM."""
    from .io.cram import CramStream, decode_slice, \
        parse_compression_header, split_slices

    with CramStream(path) as cs0:
        ref_names = list(cs0.ref_names)

    def chunks():
        with CramStream(path) as cs:
            for cont, blocks, _ in cs.containers():
                comp = parse_compression_header(blocks[0].data)
                recs = []
                for group in split_slices(blocks):
                    recs.extend(decode_slice(comp, group, cont.ref_id,
                                             refs, cs.ref_names))
                if not recs:
                    continue
                offs, sizes, parts = [], [], []
                pos = 0
                for r in recs:
                    body = bytes(r.data)
                    parts.append(body)
                    offs.append(pos)
                    sizes.append(len(body))
                    pos += len(body)
                yield (np.frombuffer(b"".join(parts), np.uint8),
                       np.asarray(offs, np.int64),
                       np.asarray(sizes, np.int64))

    return ref_names, chunks()


def benchmark_bam(bam_path: str, ref_path: str, vcf_path: str,
                  fastq_path: str | None = None, label: str = "kbbq-tpu"):
    """Per-reported-Q (errors, totals) histogram from alignments.

    Streams the input in chunks (bounded memory at WGS scale) — BAM via
    the raw BGZF chunk reader, CRAM container-at-a-time (CIGARs
    reconstructed from features; the --reference FASTA doubles as the
    CRAM reference)."""
    import struct

    refs = read_fasta(ref_path)
    sites = read_vcf_sites(vcf_path)

    fq_quals = None
    if fastq_path:
        from .io.fastq import read_fastq
        fq = read_fastq(fastq_path)
        fq_quals = {}
        for i in range(fq.num_reads):
            name = fq.name_bytes(i).split()[0].decode()
            q = np.frombuffer(fq.qual_bytes(i), np.uint8).astype(
                np.int64) - 33
            fq_quals[_strip_pair_suffix(name)] = q

    totals = np.zeros(NUM_Q, dtype=np.int64)
    errors = np.zeros(NUM_Q, dtype=np.int64)
    if str(bam_path).endswith(".cram"):
        ref_names, raw_chunks = _cram_record_chunks(bam_path, refs)
    else:
        from .io.bam_stream import iter_bam_raw_chunks
        _, bam_refs, raw_chunks = iter_bam_raw_chunks(bam_path)
        ref_names = [name for name, _ in bam_refs]

    # Per-chromosome precompute (once, not per record / per segment):
    # base codes via a 256-entry LUT and a dense variable-site bool mask
    # (replaces an np.isin sort per CIGAR-M segment).
    lut = np.full(256, 4, dtype=np.int8)
    for code, ch in enumerate(b"ACGT"):
        lut[ch] = code
    ref_codes_by_name: dict[str, np.ndarray] = {}
    var_mask_by_name: dict[str, np.ndarray] = {}
    for rname, ref in refs.items():
        arr = np.frombuffer(ref, dtype=np.uint8)
        ref_codes_by_name[rname] = lut[arr]
        vm = np.zeros(arr.size, dtype=bool)
        var = sites.get(rname)
        if var is not None and var.size:
            vm[var[(var >= 0) & (var < arr.size)]] = True
        var_mask_by_name[rname] = vm

    # Nibble decode LUT: byte -> (hi code, lo code), for whole-chunk
    # sequence decoding in one vectorized pass
    nib = np.full(16, 4, dtype=np.int8)
    for code, v in enumerate((1, 2, 4, 8)):
        nib[v] = code
    byte_hi = nib[np.arange(256) >> 4]
    byte_lo = nib[np.arange(256) & 0xF]

    # Accumulate all M-segment (q, err) pairs in flat buffers and
    # histogram once at the end — np.add.at per segment is slow.
    q_chunks: list[np.ndarray] = []
    e_chunks: list[np.ndarray] = []

    # per-refid lookup tables (None = chromosome absent from the FASTA)
    ref_codes_by_id = [ref_codes_by_name.get(nm) for nm in ref_names]
    var_mask_by_id = [var_mask_by_name.get(nm) for nm in ref_names]
    ref_len_by_id = np.asarray(
        [len(rc) if rc is not None else -1 for rc in ref_codes_by_id],
        np.int64)

    def slow_record(buf, o, size, q):
        """Arbitrary-CIGAR fallback (rare shapes) via a BamRecord."""
        from .io.bam import record_from_body
        rec = record_from_body(bytearray(bytes(buf[o:o + size])))
        rc = ref_codes_by_id[rec.refid]
        vm = var_mask_by_id[rec.refid]
        (_, _, l_read_name, _, _, n_cigar, _, _, _, _, _) = \
            struct.unpack_from("<iiBBHHHiiii", rec.data, 0)
        cig = parse_cigar(rec.data, 32 + l_read_name, n_cigar)
        seq = rec.seq_codes()
        qv = q if q is not None else rec.quals().astype(np.int64)
        rpos = rec.pos
        spos = 0
        for op, ln in cig:
            if op in ("M", "=", "X"):
                rr = rc[rpos:rpos + ln]
                s = seq[spos:spos + ln]
                qq = np.clip(qv[spos:spos + ln], 0, NUM_Q - 1)
                use = (~vm[rpos:rpos + ln]) & (rr != 4) & (s != 4)
                er = use & (s != rr)
                q_chunks.append(qq[use])
                e_chunks.append(qq[er])
                rpos += ln
                spos += ln
            elif op in ("I", "S"):
                spos += ln
            elif op in ("D", "N"):
                rpos += ln
            # H, P consume nothing

    # single source of truth for the BAM record layout: io/bam_vec.py
    # field math (no second hand-rolled reader to keep in sync)
    from .io.bam_vec import _u32, bam_fields

    for buf, offs, sizes in raw_chunks:
        # whole-chunk vector field extraction — no per-record objects
        F = bam_fields(buf, offs)
        refid, pos, l_rn = F["refid"], F["pos"], F["l_rn"]
        n_cig, flag, l_seq = F["n_cig"], F["flag"], F["l_seq"]
        keep = (refid >= 0) & ((flag & 0x904) == 0)
        keep &= np.isin(refid, np.flatnonzero(ref_len_by_id >= 0))
        cig_off = offs + 32 + l_rn
        # first cigar op (guarded: only meaningful where n_cig >= 1)
        safe = np.minimum(cig_off, buf.size - 4)
        first = _u32(buf, safe)
        single_m = (n_cig == 1) & ((first & 0xF) == 0) & \
            ((first >> 4) == l_seq)
        in_ref = pos + l_seq <= ref_len_by_id[np.clip(refid, 0, None)]
        fast = keep & single_m & in_ref & (fq_quals is None)

        idx_slow = np.flatnonzero(keep & ~fast)
        for i in idx_slow:
            q = None
            if fq_quals is not None:
                o = int(offs[i])
                name = bytes(buf[o + 32:o + 32 + int(l_rn[i]) - 1]
                             ).decode()
                q = fq_quals.get(_strip_pair_suffix(name))
                if q is None:
                    continue
                if flag[i] & 0x10:
                    q = q[::-1]
            slow_record(buf, int(offs[i]), int(sizes[i]), q)

        # vectorized scoring per (refid, length) group
        idx_fast = np.flatnonzero(fast)
        if idx_fast.size == 0:
            continue
        seq_off = F["seq_off"]
        key = refid[idx_fast] * (1 << 32) + l_seq[idx_fast]
        for kkey in np.unique(key):
            sel = idx_fast[key == kkey]
            rid = int(refid[sel[0]])
            L = int(l_seq[sel[0]])
            nb = (L + 1) // 2
            so = seq_off[sel]
            # seq nibbles + quals are CONTIGUOUS per record: one row
            # copy each (a 2-D fancy gather here was 2x the whole
            # budget; 65k small memcpys are ~20x cheaper)
            span = nb + L
            raw = np.empty((sel.size, span), dtype=np.uint8)
            for i, o in enumerate(so):
                raw[i] = buf[o:o + span]
            packed = raw[:, :nb]
            seq = np.empty((sel.size, 2 * nb), dtype=np.int8)
            seq[:, 0::2] = byte_hi[packed]
            seq[:, 1::2] = byte_lo[packed]
            seq = seq[:, :L]
            quals = raw[:, nb:nb + L]
            p = pos[sel]
            rc_full = ref_codes_by_id[rid]
            vm_full = var_mask_by_id[rid]
            rr = np.empty((sel.size, L), dtype=np.int8)
            vm = np.empty((sel.size, L), dtype=bool)
            for i, o in enumerate(p):
                rr[i] = rc_full[o:o + L]
                vm[i] = vm_full[o:o + L]
            qq = np.minimum(quals, NUM_Q - 1)
            use = (~vm) & (rr != 4) & (seq != 4)
            err = use & (seq != rr)
            q_chunks.append(qq[use])
            e_chunks.append(qq[err])

        if sum(x.size for x in q_chunks) > 50_000_000:
            totals += np.bincount(np.concatenate(q_chunks),
                                  minlength=NUM_Q)[:NUM_Q]
            errors += np.bincount(np.concatenate(e_chunks),
                                  minlength=NUM_Q)[:NUM_Q]
            q_chunks.clear()
            e_chunks.clear()
    if q_chunks:
        totals += np.bincount(np.concatenate(q_chunks), minlength=NUM_Q
                              )[:NUM_Q]
        errors += np.bincount(np.concatenate(e_chunks), minlength=NUM_Q
                              )[:NUM_Q]
    return {"label": label, "totals": totals, "errors": errors}


def write_tsv(result: dict, out) -> None:
    close = False
    if isinstance(out, str) and out != "-":
        out = open(out, "w")
        close = True
    elif out == "-":
        out = sys.stdout
    out.write("label\treportedQ\tactualQ\tcount\n")
    for q in range(NUM_Q):
        n = int(result["totals"][q])
        if n == 0:
            continue
        e = int(result["errors"][q])
        actual = -10.0 * math.log10((e + 1) / (n + 2))
        out.write(f"{result['label']}\t{q}\t{actual:.4f}\t{n}\n")
    if close:
        out.close()


def benchmark_to_tsv(args) -> int:
    result = benchmark_bam(args.bam, args.reference, args.vcf,
                           fastq_path=args.fastq, label=args.label)
    write_tsv(result, args.output)
    return 0

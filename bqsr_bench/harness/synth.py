"""The benchmark's frozen sample generators (NumPy only).

A frozen copy of the draws and layouts of ``kbbq_tpu_torch/utils/synth.py``
(``make_arrays_fast``, ``read_starts``, ``arrays_to_fastq_bytes``,
``arrays_to_bam_bytes``), kept here so that no later change to the program
changes what the benchmark feeds it.  The same seed gives the same reads as
the program's generator; ``bqsr_bench/tests`` holds the two to each other at
a small size.  Nothing here imports the program.

The BAM side also builds the byte stream that a recalibration must write
(``bam_stream`` with new qualities and OQ tags), which the reference uses
to judge the program's output.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()
# BAM's 4-bit base codes of A, C, G, T, N
CODE_TO_NIBBLE = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
BAM_MAGIC = b"BAM\x01"
# read groups of the BAM sample, by order of first appearance
BAM_READ_GROUPS = ("grpA", "grpB", "grpC")
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
BGZF_BLOCK = 0xFF00
BGZF_LEVEL = 2
QUAL_OFFSET = 33


def seed_of(seed: int) -> int:
    """A command-line seed as NumPy takes it (any whole number)."""
    return int(seed) % (1 << 64)


def make_reads(genome_len: int, read_len: int, num_reads: int,
               error_rate: float, seed: int, paired: bool = True):
    """``make_arrays_fast``'s draws, in its order -> dict of codes (int8
    [N, L], A=0 C=1 G=2 T=3), quals (int8 [N, L]), seconds (bool [N]) and
    starts (int64 [N], each read's 0-based start on the genome).  Every read
    has the full length and one read group."""
    rng = np.random.default_rng(seed_of(seed))
    genome = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    starts = rng.integers(0, genome_len - read_len + 1, size=num_reads)
    codes = genome[starts[:, None] + np.arange(read_len)]
    quals = rng.choice(np.array([12, 20, 28, 37], dtype=np.int8),
                       size=(num_reads, read_len),
                       p=[0.1, 0.2, 0.3, 0.4])
    err = rng.random((num_reads, read_len)) < error_rate
    sub = (codes + rng.integers(1, 4, size=codes.shape)) % 4
    codes = np.where(err, sub, codes).astype(np.int8)
    seconds = (np.arange(num_reads) % 2 == 1) & bool(paired)
    return {"codes": codes, "quals": quals, "seconds": seconds,
            "starts": np.asarray(starts, np.int64)}


# ------------------------------------------------------------------ FASTQ

def fastq_record_layout(read_len: int):
    """(record bytes, offset of the quality line) of one rendered record:
    ``@r<pair, 9 digits>/<1|2>``, the bases, ``+``, the qualities."""
    head = 1 + 1 + 9 + 2 + 1
    qual_at = head + read_len + 3
    return qual_at + read_len + 1, qual_at


def fastq_bytes(codes, quals, seconds, first: int = 0) -> bytes:
    """FASTQ text of full-length reads (``arrays_to_fastq_bytes``): record
    i is named ``r<(first + i) // 2, 9 digits>/<2 if seconds[i] else 1>``."""
    codes = np.asarray(codes)
    n, L = codes.shape
    rec, qual_at = fastq_record_layout(L)
    out = np.empty((n, rec), dtype=np.uint8)
    out[:, 0] = ord("@")
    out[:, 1] = ord("r")
    pair = (first + np.arange(n, dtype=np.int64)) // 2
    for d in range(9):
        out[:, 2 + d] = (pair // 10 ** (8 - d)) % 10 + ord("0")
    out[:, 11] = ord("/")
    out[:, 12] = np.where(np.asarray(seconds), ord("2"), ord("1"))
    out[:, 13] = 10
    out[:, 14:14 + L] = DECODE[codes]
    out[:, 14 + L] = 10
    out[:, 15 + L] = ord("+")
    out[:, 16 + L] = 10
    out[:, qual_at:qual_at + L] = np.asarray(quals).astype(np.uint8) \
        + QUAL_OFFSET
    out[:, qual_at + L] = 10
    return out.tobytes()


def write_fastq(path: str, reads: dict, step: int = 1 << 18) -> int:
    """Write the reads as one FASTQ file, `step` records at a time ->
    bytes written."""
    n = reads["codes"].shape[0]
    size = 0
    with open(path, "wb") as f:
        for s in range(0, n, step):
            e = min(n, s + step)
            size += f.write(fastq_bytes(reads["codes"][s:e],
                                        reads["quals"][s:e],
                                        reads["seconds"][s:e], first=s))
    return size


# -------------------------------------------------------------------- BAM

def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The SAM spec's reg2bin of [beg, end), vectorized."""
    end = end - 1
    out = np.zeros(beg.shape, np.int64)
    for shift, first in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out = np.where(beg >> shift == end >> shift, first + (beg >> shift),
                       out)
    return out


def alignment_layout(reads: dict, extra_share: float = 0.01) -> dict:
    """The records of the coordinate-sorted BAM sample, as arrays in file
    order (``_alignment_layout`` of the program's generator): rows (the
    read behind each primary record, in file order), src (the read behind
    each record), copy / supp (secondary or supplementary copies), flag,
    prim_index, codes and quals in stored orientation, rev, pos, names,
    rg (index into BAM_READ_GROUPS), header and ref_len.  The strand and
    copy draws come from a fixed seed, so every sample has the same number
    of records."""
    codes = np.asarray(reads["codes"])
    n, L = codes.shape
    starts = np.asarray(reads["starts"], np.int64)
    rng = np.random.default_rng(0)
    rev_row = rng.random(n) < 0.5
    extra_row = rng.random(n) < extra_share
    supp_row = rng.random(n) < 0.5

    rows = np.argsort(starts, kind="stable")
    per = 1 + extra_row[rows].astype(np.int64)
    first = np.cumsum(per) - per
    T = int(per.sum())
    src = np.empty(T, np.int64)
    src[first] = rows
    copy = np.zeros(T, bool)
    copy_at = first[extra_row[rows]] + 1
    src[copy_at] = rows[extra_row[rows]]
    copy[copy_at] = True
    prim_index = np.zeros(T, np.int64)
    prim_index[first] = np.arange(n)
    prim_index[copy_at] = np.flatnonzero(extra_row[rows])

    rev = rev_row[src]
    seconds = np.asarray(reads["seconds"], bool)[src]
    flag = (0x1 | 0x2 | np.where(seconds, 0x80, 0x40)
            | np.where(rev, 0x10, 0)).astype(np.int64)
    supp = copy & supp_row[src]
    flag |= np.where(copy & ~supp, 0x100, 0) | np.where(supp, 0x800, 0)

    c = codes[src]
    q = np.asarray(reads["quals"]).astype(np.uint8)[src]
    c[rev] = np.where(c[rev] < 4, 3 - c[rev], c[rev])[:, ::-1]
    q[rev] = q[rev][:, ::-1]
    q[copy & ~supp] = 0xFF
    names = np.zeros((T, 10), np.uint8)
    pair = src // 2
    names[:, 0] = ord("r")
    for d in range(9):
        names[:, 1 + d] = (pair // 10 ** (8 - d)) % 10 + ord("0")
    ref_len = int(starts.max(initial=0)) + L
    header = ["@HD\tVN:1.6\tSO:coordinate", f"@SQ\tSN:synth\tLN:{ref_len}"]
    header += [f"@RG\tID:{r}\tSM:synth\tPL:ILLUMINA"
               for r in reversed(BAM_READ_GROUPS)]
    return {"rows": rows, "src": src, "copy": copy, "supp": supp,
            "flag": flag, "prim_index": prim_index, "codes": c, "quals": q,
            "rev": rev, "pos": starts[src], "names": names,
            "rg": prim_index % len(BAM_READ_GROUPS),
            "header": "\n".join(header) + "\n", "ref_len": ref_len}


def bam_header(lay: dict) -> bytes:
    """Magic, header text and the one reference sequence."""
    htext = lay["header"].encode()
    name = b"synth\x00"
    return b"".join([BAM_MAGIC, struct.pack("<i", len(htext)), htext,
                     struct.pack("<i", 1), struct.pack("<i", len(name)), name,
                     struct.pack("<i", lay["ref_len"])])


def bam_records(lay: dict, new_quals=None, oq_quals=None):
    """(records uint8 [T, size] in file order, qual_at): every record of the
    layout with its block_size prefix, and the column of its QUAL field.

    new_quals (int8 [N, L] in machine order, rows as ``lay["rows"]`` gives
    them to the primary records): the primary records' QUAL replaced.
    oq_quals (the same form): an ``OQ:Z`` tag of those qualities appended
    to every primary record after its RG tag; the copies then carry a
    zero tail, which ``bam_stream`` drops.  That is what a recalibration
    with OQ emission writes: secondary and supplementary records pass
    through as they were."""
    c, q, src, rev = lay["codes"], lay["quals"].copy(), lay["src"], lay["rev"]
    T, L = c.shape
    prim = ~lay["copy"]
    nib = CODE_TO_NIBBLE[np.clip(c, 0, 4)]
    if L % 2:
        nib = np.concatenate([nib, np.zeros((T, 1), np.uint8)], axis=1)
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]

    def stored(machine):
        # machine-order qualities of each record's read, in stored order
        m = np.asarray(machine).astype(np.uint8)[_read_order(lay)]
        m[rev] = m[rev][:, ::-1]
        return m

    if new_quals is not None:
        q[prim] = stored(new_quals)[prim]
    rg_len = len(BAM_READ_GROUPS[0])
    oq_len = 3 + L + 1 if oq_quals is not None else 0
    aux = 3 + rg_len + 1 + oq_len
    body = 32 + 11 + 4 + (L + 1) // 2 + L + aux
    rec = np.zeros((T, 4 + body), np.uint8)

    def put(col, values, dtype):
        v = np.ascontiguousarray(np.asarray(values).astype(dtype))
        w = v.dtype.itemsize
        rec[:, col:col + w] = v.view(np.uint8).reshape(T, w)

    pos = lay["pos"]
    sizes = np.where(prim, body, body - oq_len)
    put(0, sizes, "<i4")
    put(4, np.zeros(T), "<i4")
    put(8, pos, "<i4")
    put(12, np.full(T, 11), "u1")
    put(13, np.full(T, 60), "u1")
    put(14, _reg2bin(pos, pos + L), "<u2")
    put(16, np.ones(T), "<u2")
    put(18, lay["flag"], "<u2")
    put(20, np.full(T, L), "<i4")
    put(24, np.zeros(T), "<i4")
    put(28, pos, "<i4")
    put(32, np.zeros(T), "<i4")
    rec[:, 36:46] = lay["names"]
    rec[:, 46] = 0
    put(47, np.full(T, L << 4), "<u4")
    at = 51
    rec[:, at:at + packed.shape[1]] = packed
    at += packed.shape[1]
    qual_at = at
    rec[:, at:at + L] = q
    at += L
    rec[:, at:at + 3] = np.frombuffer(b"RGZ", np.uint8)
    names = np.frombuffer(b"".join(r.encode() for r in BAM_READ_GROUPS),
                          np.uint8).reshape(len(BAM_READ_GROUPS), rg_len)
    rec[:, at + 3:at + 3 + rg_len] = names[lay["rg"]]
    at += 3 + rg_len + 1
    if oq_quals is not None:
        oq = stored(oq_quals)
        rec[prim, at:at + 3] = np.frombuffer(b"OQZ", np.uint8)
        rec[prim, at + 3:at + 3 + L] = oq[prim] + QUAL_OFFSET
        at += 3 + L + 1
    return rec, qual_at


def _read_order(lay: dict) -> np.ndarray:
    """Row of the decode-order read arrays behind each record: a record
    whose read is the j-th primary of the file has row j."""
    order = np.empty(lay["rows"].size, np.int64)
    order[lay["rows"]] = np.arange(lay["rows"].size)
    return order[lay["src"]]


def bam_stream(lay: dict, new_quals=None, oq_quals=None):
    """(uncompressed BAM bytes, record starts int64 [T], qual_at): the
    header and every record of ``bam_records`` back to back (a copy's zero
    tail left out)."""
    rec, qual_at = bam_records(lay, new_quals, oq_quals)
    head = bam_header(lay)
    sizes = rec[:, :4].copy().view("<i4")[:, 0].astype(np.int64) + 4
    if (sizes == rec.shape[1]).all():
        body = rec.reshape(-1)
    else:
        keep = np.arange(rec.shape[1])[None, :] < sizes[:, None]
        body = rec[keep]
    starts = len(head) + np.cumsum(sizes) - sizes
    return head + body.tobytes(), starts, qual_at


def decode_order(reads: dict, lay: dict) -> dict:
    """The reads as a BAM decode gives them to the recalibration: primary
    records in file order, read groups by first appearance."""
    rows = lay["rows"]
    n = rows.size
    return {"codes": reads["codes"][rows], "quals": reads["quals"][rows],
            "seconds": np.asarray(reads["seconds"])[rows],
            "rgs": (np.arange(n) % len(BAM_READ_GROUPS)).astype(np.int64),
            "num_rg": len(BAM_READ_GROUPS)}


def _bgzf_block(chunk: bytes) -> bytes:
    co = zlib.compressobj(BGZF_LEVEL, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    bsize = len(cdata) + 26
    hdr = struct.pack("<4BI2BH", 31, 139, 8, 4, 0, 0, 255, 6)
    extra = struct.pack("<2B2H", 66, 67, 2, bsize - 1)
    tail = struct.pack("<II", zlib.crc32(chunk), len(chunk))
    return hdr + extra + cdata + tail


def bgzf_compress(data: bytes, threads: int = 8) -> bytes:
    """BGZF blocks of BGZF_BLOCK input bytes at deflate level 2, and the EOF
    marker (zlib releases the interpreter lock, so threads compress blocks
    side by side)."""
    view = memoryview(data)
    spans = [view[s:s + BGZF_BLOCK] for s in range(0, len(data), BGZF_BLOCK)]
    with ThreadPoolExecutor(threads) as pool:
        blocks = list(pool.map(_bgzf_block, spans, chunksize=64))
    return b"".join(blocks) + BGZF_EOF


def bgzf_inflate(data, threads: int = 8) -> bytes:
    """The content of a BGZF byte string, each block checked: gzip magic,
    the BC subfield and its size, CRC32 and length, and the EOF marker at
    the end.  Raises ValueError on the first fault."""
    buf = memoryview(data)
    spans = []
    at = 0
    while at < len(buf):
        if len(buf) - at < 28 or bytes(buf[at:at + 4]) != b"\x1f\x8b\x08\x04":
            raise ValueError(f"no BGZF block header at byte {at}")
        xlen = struct.unpack_from("<H", buf, at + 10)[0]
        si1, si2, slen, bsize = struct.unpack_from("<2B2H", buf, at + 12)
        if (si1, si2, slen, xlen) != (66, 67, 2, 6):
            raise ValueError(f"no BC subfield in the block at byte {at}")
        end = at + bsize + 1
        if end > len(buf):
            raise ValueError(f"truncated BGZF block at byte {at}")
        spans.append((at, end))
        at = end
    if not spans or bytes(buf[spans[-1][0]:spans[-1][1]]) != BGZF_EOF:
        raise ValueError("no BGZF EOF marker at the end")

    def inflate(span):
        s, e = span
        try:
            out = zlib.decompress(bytes(buf[s + 18:e - 8]), -15)
        except zlib.error as exc:
            raise ValueError(f"the block at byte {s}: {exc}") from exc
        crc, isize = struct.unpack_from("<II", buf, e - 8)
        if zlib.crc32(out) != crc or len(out) != isize:
            raise ValueError(f"CRC or size mismatch in the block at byte {s}")
        return out

    with ThreadPoolExecutor(threads) as pool:
        return b"".join(pool.map(inflate, spans, chunksize=64))


def write_bam(path: str, reads: dict, extra_share: float = 0.01) -> dict:
    """Write the reads as a coordinate-sorted BGZF BAM -> its layout."""
    lay = alignment_layout(reads, extra_share)
    raw, _, _ = bam_stream(lay)
    with open(path, "wb") as f:
        f.write(bgzf_compress(raw))
    return lay

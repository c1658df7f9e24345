"""Synthetic genome / read-set generation for tests and smoke runs.

Copy of ``kbbq_tpu/utils/synth.py`` with the same numpy RNG calls in the
same order, so the same seed gives the same reads in both packages; the
planted errors are known, so calibration can be validated against ground
truth.  ``arrays_to_fastq_bytes``, ``arrays_to_fastq_file``,
``arrays_to_bam_bytes`` and ``arrays_to_cram_bytes`` (vectorized FASTQ,
BAM and CRAM writers of a ReadArrays), ``read_starts`` and
``make_arrays_chunked`` (``scripts/chr20.py``'s generator) are the port's
additions.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..constants import BASE_N


@dataclasses.dataclass
class SynthDataset:
    genome: np.ndarray            # int8 [G] base codes
    codes: list                   # per-read int8 arrays (with errors applied)
    quals: list                   # per-read int arrays (reported phred)
    rgs: list
    seconds: list
    true_errors: list             # per-read bool arrays (planted error mask)
    names: list


def make_dataset(
    genome_len: int = 20_000,
    read_len: int = 100,
    coverage: float = 30.0,
    error_rate: float = 0.01,
    seed: int = 0,
    num_rg: int = 1,
    paired: bool = False,
    n_rate: float = 0.0,
) -> SynthDataset:
    """Uniform random genome; uniform read start positions; planted
    substitution errors at `error_rate`; reported quality drawn to loosely
    correlate with error probability (so recalibration has signal)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.int8)
    num_reads = max(1, int(genome_len * coverage / read_len))

    codes, quals, rgs, seconds, true_errors, names = [], [], [], [], [], []
    for r in range(num_reads):
        start = int(rng.integers(0, genome_len - read_len + 1))
        read = genome[start:start + read_len].copy()
        # reported qualities: mixture so the table has spread
        q = rng.choice([12, 20, 28, 37], size=read_len,
                       p=[0.1, 0.2, 0.3, 0.4]).astype(np.int64)
        # planted errors: probability scales with true phred-ish error rate
        p_err = np.minimum(1.0, error_rate * np.power(10.0, (25 - q) / 20.0))
        err = rng.random(read_len) < p_err
        if err.any():
            orig = read[err]
            sub = (orig + rng.integers(1, 4, size=orig.shape)) % 4
            read[err] = sub
        if n_rate > 0:
            nmask = rng.random(read_len) < n_rate
            read[nmask] = BASE_N
            err = err & ~nmask
        codes.append(read.astype(np.int8))
        quals.append(q)
        rgs.append(int(r % num_rg))
        seconds.append(bool(paired and (r % 2 == 1)))
        true_errors.append(err)
        names.append(f"synth_read_{r}")
    return SynthDataset(genome, codes, quals, rgs, seconds, true_errors, names)


def make_arrays_fast(
    genome_len: int = 4_600_000,
    read_len: int = 150,
    num_reads: int = 1_000_000,
    error_rate: float = 0.005,
    seed: int = 0,
    num_rg: int = 1,
    paired: bool = True,
):
    """Fully vectorized large-scale generator -> (ReadArrays, true_errors).

    For E.-coli-scale datasets; no per-read Python loop.
    """
    from ..io.batcher import ReadArrays

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    starts = rng.integers(0, genome_len - read_len + 1, size=num_reads)
    idx = starts[:, None] + np.arange(read_len)
    codes = genome[idx]
    quals = rng.choice(np.array([12, 20, 28, 37], dtype=np.int8),
                       size=(num_reads, read_len),
                       p=[0.1, 0.2, 0.3, 0.4])
    err = rng.random((num_reads, read_len)) < error_rate
    sub = (codes + rng.integers(1, 4, size=codes.shape)) % 4
    codes = np.where(err, sub, codes).astype(np.int8)
    mask = np.ones((num_reads, read_len), dtype=bool)
    rgs = (np.arange(num_reads) % num_rg).astype(np.int32)
    seconds = ((np.arange(num_reads) % 2 == 1) & paired)
    arrays = ReadArrays(codes, quals, mask, rgs, seconds)
    return arrays, err


def make_arrays_chunked(num_reads: int, read_len: int = 150,
                        coverage: float = 30.0, seed: int = 0,
                        step: int = 1 << 20):
    """The chr20-class generator of BASELINE config 4 -> ReadArrays:
    ``make_arrays_fast``'s data drawn `step` reads at a time, so that no
    [N, L] int64 index is ever built (at 13,000,000 x 150 it would take
    15.6 GB).  A uniform genome of max(1000, N * L / coverage) bases, one
    read group, odd rows second in pair (interleaved pairs), qualities
    12/20/28/37 and substitutions at 0.005 independent of them.  The draws
    are those of the JAX package's ``scripts/chr20.py::make_arrays``, in
    its order, so the same `step` gives the same reads (another `step`
    gives other reads)."""
    from ..io.batcher import ReadArrays

    genome_len = max(1000, int(num_reads * read_len / coverage))
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    starts = rng.integers(0, genome_len - read_len + 1, size=num_reads)
    codes = np.empty((num_reads, read_len), np.int8)
    quals = np.empty((num_reads, read_len), np.int8)
    qpal = np.array([12, 20, 28, 37], dtype=np.int8)
    for s in range(0, num_reads, step):
        e = min(num_reads, s + step)
        c = genome[starts[s:e, None] + np.arange(read_len)]
        quals[s:e] = qpal[rng.choice(4, size=(e - s, read_len),
                                     p=[0.1, 0.2, 0.3, 0.4])]
        err = rng.random((e - s, read_len)) < 0.005
        sub = (c + rng.integers(1, 4, size=c.shape)) % 4
        codes[s:e] = np.where(err, sub, c).astype(np.int8)
    return ReadArrays(codes, quals, np.ones((num_reads, read_len), bool),
                      np.zeros(num_reads, np.int32),
                      np.arange(num_reads) % 2 == 1)


def make_two_sided_reads(num_reads: int, read_len: int, k: int,
                         genome_len: int = 3000, seed: int = 0):
    """Reads with a short anchor in the middle and two planted errors on
    each side of it, all within the first 32 bases -> (clean, codes, left,
    right): the error-free reads and the reads int8 [N, L], and the two
    half-open base ranges that hold the errors.

    The left errors lie in the first k-1 bases and the right ones in the
    last k bases of the first 32, so every window in between is error-free.
    A walk that holds 32 bases in a machine word then corrects, from both
    sides of the anchor, bases of ONE word.  Needs k+1 <= 31 and
    read_len - k <= 31.
    """
    left = (0, k - 1)
    right = (max(read_len - k, k + 1), min(read_len, 32))
    if left[1] <= left[0] or right[1] <= right[0]:
        raise ValueError("no room for errors on both sides of an anchor "
                         "within the first 32 bases")
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    starts = rng.integers(0, genome_len - read_len + 1, size=num_reads)
    clean = genome[starts[:, None] + np.arange(read_len)]
    codes = clean.copy()
    row = np.arange(num_reads)
    for lo, hi in (left, right):
        for _ in range(2):
            pos = rng.integers(lo, hi, size=num_reads)
            codes[row, pos] = (clean[row, pos]
                               + rng.integers(1, 4, size=num_reads)) % 4
    return clean, codes, left, right


def to_fastq_bytes(ds: SynthDataset) -> bytes:
    """Render the dataset as an uncompressed FASTQ byte string."""
    from ..oracle.kmers import decode_seq
    out = bytearray()
    for name, codes, quals in zip(ds.names, ds.codes, ds.quals):
        out += b"@" + name.encode() + b"\n"
        out += decode_seq(codes) + b"\n+\n"
        out += bytes((np.asarray(quals) + 33).astype(np.uint8)) + b"\n"
    return bytes(out)


def arrays_to_fastq_bytes(arrays, first: int = 0) -> bytes:
    """Vectorized FASTQ render of a ReadArrays whose reads all have the
    full length (mask all True), e.g. make_arrays_fast's output.

    Record i is named ``r<ordinal of its pair, 9 digits>/<1 or 2>``, its
    ordinal being first + i: the mate is 2 where ``arrays.seconds[i]``, so
    ``FastqData.seconds_mask`` recovers the seconds flags from the names.
    No per-read Python loop.
    """
    from ..oracle.kmers import _DECODE_LUT
    codes = np.asarray(arrays.codes)
    n, L = codes.shape
    if not np.asarray(arrays.mask).all():
        raise ValueError("arrays_to_fastq_bytes needs full-length reads")
    digits = 9
    rec = 1 + 1 + digits + 2 + 1 + L + 3 + L + 1   # @r<d>/m\n seq\n+\n qual\n
    out = np.empty((n, rec), dtype=np.uint8)
    out[:, 0] = ord("@")
    out[:, 1] = ord("r")
    pair = (first + np.arange(n, dtype=np.int64)) // 2
    for d in range(digits):
        out[:, 2 + d] = (pair // 10 ** (digits - 1 - d)) % 10 + ord("0")
    c = 2 + digits
    out[:, c] = ord("/")
    out[:, c + 1] = np.where(np.asarray(arrays.seconds), ord("2"), ord("1"))
    out[:, c + 2] = 10
    c += 3
    out[:, c:c + L] = _DECODE_LUT[codes]
    c += L
    out[:, c] = 10
    out[:, c + 1] = ord("+")
    out[:, c + 2] = 10
    c += 3
    out[:, c:c + L] = np.asarray(arrays.quals).astype(np.uint8) + 33
    out[:, c + L] = 10
    return out.tobytes()


def arrays_to_fastq_file(arrays, path, step: int = 1 << 18) -> int:
    """Write ``arrays_to_fastq_bytes(arrays)`` to `path`, rendered `step`
    reads at a time (host memory O(step) past the arrays) -> bytes
    written."""
    from ..io.batcher import ReadArrays
    n = arrays.num_reads
    size = 0
    with open(path, "wb") as f:
        for s in range(0, n, step):
            e = min(n, s + step)
            part = ReadArrays(arrays.codes[s:e], arrays.quals[s:e],
                              arrays.mask[s:e], arrays.rgs[s:e],
                              arrays.seconds[s:e])
            size += f.write(arrays_to_fastq_bytes(part, first=s))
    return size


def read_starts(genome_len: int, read_len: int, num_reads: int,
                seed: int = 0) -> np.ndarray:
    """The read start positions that ``make_arrays_fast`` draws for these
    arguments (its first two draws, replayed)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 4, size=genome_len, dtype=np.int8)
    return rng.integers(0, genome_len - read_len + 1, size=num_reads)


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The SAM spec's reg2bin of [beg, end), vectorized."""
    end = end - 1
    out = np.zeros(beg.shape, np.int64)
    for shift, first in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out = np.where(beg >> shift == end >> shift, first + (beg >> shift),
                       out)
    return out


# read groups of arrays_to_bam_bytes, by order of first appearance
BAM_READ_GROUPS = ("grpA", "grpB", "grpC")


def _alignment_layout(arrays, starts, extra_share: float):
    """The records that ``arrays_to_bam_bytes`` and ``arrays_to_cram_bytes``
    write, as arrays in file order: a dict of rows (the arrays' row of each
    primary record, in file order), src (the row behind each record), copy
    (secondary or supplementary), supp, flag, prim_index (the primary
    ordinal of each record), codes and quals (int8 / uint8 [T, L], stored
    orientation), pos, names (uint8 [T, 10]), rg (the record's index into
    BAM_READ_GROUPS), header (the SAM text) and ref_len."""
    codes = np.asarray(arrays.codes)
    n, L = codes.shape
    if not np.asarray(arrays.mask).all():
        raise ValueError("the synthetic alignment writers need full-length "
                         "reads")
    starts = np.asarray(starts, np.int64)
    rng = np.random.default_rng(0)
    rev_row = rng.random(n) < 0.5
    extra_row = rng.random(n) < extra_share
    supp_row = rng.random(n) < 0.5

    rows = np.argsort(starts, kind="stable")
    # file order: each primary, then its copy where it has one
    per = 1 + extra_row[rows].astype(np.int64)
    first = np.cumsum(per) - per            # file index of each primary
    T = int(per.sum())
    src = np.empty(T, np.int64)
    src[first] = rows
    copy = np.zeros(T, bool)
    copy_at = first[extra_row[rows]] + 1
    src[copy_at] = rows[extra_row[rows]]
    copy[copy_at] = True
    prim_index = np.zeros(T, np.int64)      # primary ordinal of each record
    prim_index[first] = np.arange(n)
    prim_index[copy_at] = np.flatnonzero(extra_row[rows])

    rev = rev_row[src]
    seconds = np.asarray(arrays.seconds, bool)[src]
    flag = (0x1 | 0x2 | np.where(seconds, 0x80, 0x40)
            | np.where(rev, 0x10, 0)).astype(np.int64)
    supp = copy & supp_row[src]
    flag |= np.where(copy & ~supp, 0x100, 0) | np.where(supp, 0x800, 0)

    c = codes[src]
    q = np.asarray(arrays.quals).astype(np.uint8)[src]
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


def arrays_to_bam_bytes(arrays, starts, extra_share: float = 0.01,
                        oq_quals=None):
    """Vectorized BAM writer of a ReadArrays whose reads all have the full
    length L -> (file bytes, rows): a coordinate-sorted BAM (BGZF, level 2)
    of one reference sequence ("synth", as long as the reads reach),
    ``rows[j]`` the row of `arrays` behind the j-th primary record of the
    file.

    - Records are sorted by `starts` (the reads' 0-based positions, e.g.
      ``read_starts``; ties keep row order), ``@HD SO:coordinate``.
    - Primary record j carries ``RG:Z:BAM_READ_GROUPS[j % 3]``; the header
      lists the @RG lines in the reverse order, so header order and order
      of first appearance differ.
    - About half the records (a draw from a fixed seed) are on the reverse
      strand: their SEQ is the reverse complement of the row's codes and
      their QUAL the row's qualities reversed, so the machine-order decode
      gives the row back.  Rows with ``arrays.seconds`` are read 2 of a
      pair, the others read 1; record names are ``r<row // 2, 9 digits>``.
    - A share `extra_share` of the rows (another draw) is followed by a
      copy, half of them secondary (0x100, QUAL "*" = 0xff) and half
      supplementary (0x800, QUAL as the primary's).
    - `oq_quals` (int8 [N, L], machine order), when given, is stored as an
      OQ:Z tag after the RG tag.
    No per-record Python loop.
    """
    from ..io import bgzf
    from ..io.bam import CODE_TO_NIBBLE, bam_header_bytes

    lay = _alignment_layout(arrays, starts, extra_share)
    names = [r.encode() for r in BAM_READ_GROUPS]   # names of one length
    c, q, src, rev = lay["codes"], lay["quals"], lay["src"], lay["rev"]
    T, L = c.shape
    nib = CODE_TO_NIBBLE[np.clip(c, 0, 4)]
    if L % 2:
        nib = np.concatenate([nib, np.zeros((T, 1), np.uint8)], axis=1)
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]

    rg_len = len(names[0])
    aux = 3 + rg_len + 1 + (3 + L + 1 if oq_quals is not None else 0)
    body = 32 + 11 + 4 + (L + 1) // 2 + L + aux
    rec = np.zeros((T, 4 + body), np.uint8)

    def put(col, values, dtype):
        v = np.ascontiguousarray(np.asarray(values).astype(dtype))
        w = v.dtype.itemsize
        rec[:, col:col + w] = v.view(np.uint8).reshape(T, w)

    pos = lay["pos"]
    put(0, np.full(T, body), "<i4")
    put(4, np.zeros(T), "<i4")                          # refID
    put(8, pos, "<i4")
    put(12, np.full(T, 11), "u1")                       # l_read_name
    put(13, np.full(T, 60), "u1")                       # mapq
    put(14, _reg2bin(pos, pos + L), "<u2")
    put(16, np.ones(T), "<u2")                          # n_cigar_op
    put(18, lay["flag"], "<u2")
    put(20, np.full(T, L), "<i4")                       # l_seq
    put(24, np.zeros(T), "<i4")                         # next refID
    put(28, pos, "<i4")                                 # next pos
    put(32, np.zeros(T), "<i4")                         # tlen
    rec[:, 36:46] = lay["names"]
    rec[:, 46] = 0
    put(47, np.full(T, L << 4), "<u4")                  # L M
    at = 51
    rec[:, at:at + packed.shape[1]] = packed
    at += packed.shape[1]
    rec[:, at:at + L] = q
    at += L
    rec[:, at:at + 3] = np.frombuffer(b"RGZ", np.uint8)
    table = np.frombuffer(b"".join(names), np.uint8).reshape(len(names),
                                                             rg_len)
    rec[:, at + 3:at + 3 + rg_len] = table[lay["rg"]]
    at += 3 + rg_len + 1
    if oq_quals is not None:
        oq = np.asarray(oq_quals).astype(np.uint8)[src]
        oq[rev] = oq[rev][:, ::-1]
        rec[:, at:at + 3] = np.frombuffer(b"OQZ", np.uint8)
        rec[:, at + 3:at + 3 + L] = oq + 33
        at += 3 + L + 1
    assert at == 4 + body

    head = np.frombuffer(bam_header_bytes(lay["header"],
                                          [("synth", lay["ref_len"])]),
                         np.uint8)
    return (bgzf.compress(np.concatenate([head, rec.reshape(-1)])),
            lay["rows"])


def arrays_to_cram_bytes(arrays, starts, extra_share: float = 0.01,
                         oq_quals=None, records_per_container: int = 100000):
    """Vectorized CRAM writer of the records ``arrays_to_bam_bytes`` writes
    -> (file bytes, rows): the bytes ``io/cram_write.py::write_cram`` gives
    for those records under the same clock (its no-reference profile: one
    slice per container of `records_per_container` records, each mapped
    record one 'b' feature of its stored bases, QS its stored qualities,
    RG the index of its read group among the header's @RG lines, names
    preserved; `oq_quals`, when given, as each record's one tag, OQ:Z).
    The series are built a column at a time (``write_itf8_array``); no
    per-record Python loop."""
    from ..io.cram_codecs import write_itf8, write_itf8_array, write_ltf8
    from ..io.cram_write import (_EOF_CONTAINER, _TAG_CID0, CID, _arr_itf8,
                                 _block, _container_header,
                                 _encoding_external, _encoding_stop, _map)

    lay = _alignment_layout(arrays, starts, extra_share)
    c, q = lay["codes"], lay["quals"]
    T, L = c.shape
    bases = np.frombuffer(b"ACGTN", np.uint8)[np.clip(c, 0, 4)]
    # the header's @RG lines list BAM_READ_GROUPS in reverse order
    rg_index = len(BAM_READ_GROUPS) - 1 - lay["rg"]
    term = np.zeros((T, 1), np.uint8)
    oq = None
    if oq_quals is not None:
        oq = np.asarray(oq_quals).astype(np.uint8)[lay["src"]]
        oq[lay["rev"]] = oq[lay["rev"]][:, ::-1]
        oq = np.concatenate([oq + np.uint8(33), term], axis=1)
    # an OQ:Z tag on every record: one tag line, one tag series
    oq_key = (ord("O") << 16) | (ord("Q") << 8) | ord("Z")
    td = b"OQZ\x00" if oq is not None else b"\x00"
    tags = [] if oq is None else [write_itf8(oq_key)
                                  + _encoding_stop(0, _TAG_CID0)]

    out = [b"CRAM", bytes([3, 0]), bytes(20)]
    htext = lay["header"].encode()
    hblock = _block(0, 0, 0, struct.pack("<i", len(htext)) + htext)
    out += [_container_header(len(hblock), -1, 0, 0, 0, 0, 0, 1, [0]),
            hblock]

    # the compression header: no reference, one tag line
    pres = [b"RN" + bytes([1]), b"AP" + bytes([0]), b"RR" + bytes([0]),
            b"SM" + bytes([0x1B] * 5), b"TD" + write_itf8(len(td)) + td]
    ds = [key.encode() + _encoding_external(CID[key])
          for key in ("BF", "CF", "RI", "RL", "AP", "RG", "TL", "FN", "FP",
                      "MQ", "BS")]
    ds += [b"RN" + _encoding_stop(0, CID["RN"]),
           b"FC" + _encoding_external(CID["FC"]),
           b"BB" + _encoding_stop(0, CID["BB"]),
           b"QS" + _encoding_external(CID["QS"]),
           b"BA" + _encoding_external(CID["BA"])]
    comp_raw = _map(pres, len(pres)) + _map(ds, len(ds)) \
        + _map(tags, len(tags))

    for s in range(0, T, records_per_container):
        e = min(T, s + records_per_container)
        m = e - s
        ones = np.ones(m, np.int64)
        streams = {
            "BF": write_itf8_array(lay["flag"][s:e]),
            "CF": write_itf8_array(ones),
            "RI": write_itf8_array(0 * ones),
            "RL": write_itf8_array(L * ones),
            "AP": write_itf8_array(lay["pos"][s:e] + 1),
            "RG": write_itf8_array(rg_index[s:e]),
            "RN": np.concatenate([lay["names"][s:e], term[:m]],
                                 axis=1).tobytes(),
            "TL": write_itf8_array(0 * ones),
            "FN": write_itf8_array(ones),
            "FC": b"b" * m,
            "FP": write_itf8_array(ones),
            "BB": np.concatenate([bases[s:e], term[:m]], axis=1).tobytes(),
            "MQ": write_itf8_array(0 * ones),
            "QS": q[s:e].tobytes()}
        ext = [(cid, _block(4, 4, cid, streams[key]))
               for key, cid in CID.items() if streams.get(key)]
        if oq is not None:
            ext.append((_TAG_CID0, _block(1, 4, _TAG_CID0,
                                          oq[s:e].tobytes())))
        comp_block = _block(1, 1, 0, comp_raw)
        sh = (write_itf8(-2) + write_itf8(0) + write_itf8(0) + write_itf8(m)
              + write_ltf8(s) + write_itf8(1 + len(ext))
              + _arr_itf8([cid for cid, _ in ext]) + write_itf8(-1)
              + bytes(16))
        body = (comp_block + _block(0, 2, 0, sh) + _block(0, 5, 0, b"")
                + b"".join(b for _, b in ext))
        out += [_container_header(len(body), -2, 0, 0, m, s, m * L,
                                  3 + len(ext), [len(comp_block)]), body]
    out.append(_EOF_CONTAINER)
    return b"".join(out), lay["rows"]

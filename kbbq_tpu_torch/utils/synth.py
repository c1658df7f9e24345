"""Synthetic genome / read-set generation for tests and smoke runs.

Copy of ``kbbq_tpu/utils/synth.py`` with the same numpy RNG calls in the
same order, so the same seed gives the same reads in both packages; the
planted errors are known, so calibration can be validated against ground
truth.  ``arrays_to_fastq_bytes`` and ``arrays_to_bam_bytes`` (vectorized
FASTQ and BAM writers of a ReadArrays) and ``read_starts`` are the port's
additions.
"""

from __future__ import annotations

import dataclasses

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


def arrays_to_fastq_bytes(arrays) -> bytes:
    """Vectorized FASTQ render of a ReadArrays whose reads all have the
    full length (mask all True), e.g. make_arrays_fast's output.

    Record i is named ``r<ordinal of its pair, 9 digits>/<1 or 2>``: the
    mate is 2 where ``arrays.seconds[i]``, so ``FastqData.seconds_mask``
    recovers the seconds flags from the names.  No per-read Python loop.
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
    pair = np.arange(n, dtype=np.int64) // 2
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

    codes = np.asarray(arrays.codes)
    n, L = codes.shape
    if not np.asarray(arrays.mask).all():
        raise ValueError("arrays_to_bam_bytes needs full-length reads")
    names = [r.encode() for r in BAM_READ_GROUPS]   # names of one length
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

    pos = starts[src]
    put(0, np.full(T, body), "<i4")
    put(4, np.zeros(T), "<i4")                          # refID
    put(8, pos, "<i4")
    put(12, np.full(T, 11), "u1")                       # l_read_name
    put(13, np.full(T, 60), "u1")                       # mapq
    put(14, _reg2bin(pos, pos + L), "<u2")
    put(16, np.ones(T), "<u2")                          # n_cigar_op
    put(18, flag, "<u2")
    put(20, np.full(T, L), "<i4")                       # l_seq
    put(24, np.zeros(T), "<i4")                         # next refID
    put(28, pos, "<i4")                                 # next pos
    put(32, np.zeros(T), "<i4")                         # tlen
    pair = src // 2
    rec[:, 36] = ord("r")
    for d in range(9):
        rec[:, 37 + d] = (pair // 10 ** (8 - d)) % 10 + ord("0")
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
    rec[:, at + 3:at + 3 + rg_len] = table[prim_index % len(names)]
    at += 3 + rg_len + 1
    if oq_quals is not None:
        oq = np.asarray(oq_quals).astype(np.uint8)[src]
        oq[rev] = oq[rev][:, ::-1]
        rec[:, at:at + 3] = np.frombuffer(b"OQZ", np.uint8)
        rec[:, at + 3:at + 3 + L] = oq + 33
        at += 3 + L + 1
    assert at == 4 + body

    ref_len = int(starts.max(initial=0)) + L
    header = ["@HD\tVN:1.6\tSO:coordinate", f"@SQ\tSN:synth\tLN:{ref_len}"]
    header += [f"@RG\tID:{r}\tSM:synth\tPL:ILLUMINA"
               for r in reversed(BAM_READ_GROUPS)]
    head = np.frombuffer(bam_header_bytes("\n".join(header) + "\n",
                                          [("synth", ref_len)]), np.uint8)
    return bgzf.compress(np.concatenate([head, rec.reshape(-1)])), rows

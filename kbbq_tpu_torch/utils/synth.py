"""Synthetic genome / read-set generation for tests and smoke runs.

Copy of ``kbbq_tpu/utils/synth.py`` with the same numpy RNG calls in the
same order, so the same seed gives the same reads in both packages; the
planted errors are known, so calibration can be validated against ground
truth.  ``arrays_to_fastq_bytes`` (vectorized FASTQ render of a ReadArrays)
is the port's addition.
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

"""What a recalibration must write, and the comparison that decides
``correct``.

The expected output is built from the generated reads and the reference's
new qualities with the benchmark's own writers (``harness/synth.py``): for
FASTQ every record as the input had it with its quality line replaced; for
BAM every record of the input with each primary record's QUAL replaced
and, with OQ emission, an ``OQ:Z`` tag of its original qualities appended
after its RG tag, secondary and supplementary records as they were.  The
program's output is compared with it byte for byte (a BAM output after its
BGZF blocks are inflated and checked), and two numbers come out:

- ``qual_bytes_wrong``: bytes of the new quality strings that differ;
- ``other_bytes_wrong``: every other byte that differs (names, bases,
  separators, record fields, OQ tags), plus the difference in length, plus
  one where the BGZF container is broken.
"""

from __future__ import annotations

import numpy as np

from ..harness import synth


def same_bytes(a, b, step: int = 1 << 24) -> bool:
    """Whether two byte buffers hold the same bytes, compared 8 bytes at a
    time in slices of `step` (a memoryview compares element by element)."""
    if len(a) != len(b):
        return False
    x, y = np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8)
    n = x.size // 8 * 8
    for s in range(0, n, step):
        e = min(n, s + step)
        if not np.array_equal(x[s:e].view(np.uint64), y[s:e].view(np.uint64)):
            return False
    return bool(np.array_equal(x[n:], y[n:]))


def _diff_positions(got: bytes, want: bytes) -> np.ndarray:
    """Positions below the shorter length at which the two differ."""
    m = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, count=m)
    b = np.frombuffer(want, np.uint8, count=m)
    return np.flatnonzero(a != b)


class FastqExpected:
    """The FASTQ a recalibration of `reads` must write."""

    def __init__(self, reads: dict, new_quals: np.ndarray):
        self.n, self.L = reads["codes"].shape
        self.rec, self.qual_at = synth.fastq_record_layout(self.L)
        self.data = synth.fastq_bytes(reads["codes"], new_quals,
                                      reads["seconds"])

    def as_written(self) -> bytes:
        """The file a recalibration writes."""
        return self.data

    def judge(self, got: bytes) -> dict:
        if same_bytes(got, self.data):
            return {"qual_bytes_wrong": 0, "other_bytes_wrong": 0}
        pos = _diff_positions(got, self.data)
        col = pos % self.rec
        qual = int(((col >= self.qual_at)
                    & (col < self.qual_at + self.L)).sum())
        return {"qual_bytes_wrong": qual,
                "other_bytes_wrong": int(pos.size) - qual
                + abs(len(got) - len(self.data))}


class BamExpected:
    """The BAM content a recalibration of the sample laid out as `lay`
    must write (new_quals in decode order; with set_oq the OQ tags)."""

    def __init__(self, reads: dict, lay: dict, new_quals: np.ndarray,
                 set_oq: bool):
        dec = synth.decode_order(reads, lay)
        self.L = reads["codes"].shape[1]
        self.data, self.starts, self.qual_at = synth.bam_stream(
            lay, new_quals, dec["quals"] if set_oq else None)
        self.primary = ~lay["copy"]

    def as_written(self) -> bytes:
        """The file a recalibration writes (BGZF at level 2)."""
        return synth.bgzf_compress(self.data)

    def judge(self, got_bgzf: bytes) -> dict:
        try:
            got = synth.bgzf_inflate(got_bgzf)
        except ValueError:
            return {"qual_bytes_wrong": 0, "other_bytes_wrong":
                    len(self.data) + 1}
        if same_bytes(got, self.data):
            return {"qual_bytes_wrong": 0, "other_bytes_wrong": 0}
        pos = _diff_positions(got, self.data)
        rec = np.searchsorted(self.starts, pos, side="right") - 1
        inrec = pos - self.starts[np.maximum(rec, 0)]
        qual = int(((rec >= 0) & self.primary[np.maximum(rec, 0)]
                    & (inrec >= self.qual_at)
                    & (inrec < self.qual_at + self.L)).sum())
        return {"qual_bytes_wrong": qual,
                "other_bytes_wrong": int(pos.size) - qual
                + abs(len(got) - len(self.data))}

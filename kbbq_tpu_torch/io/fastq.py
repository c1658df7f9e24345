"""Vectorized FASTQ reader/writer (plain or gzip), NumPy only.

Counterpart of ``kbbq_tpu/io/fastq.py`` without its native C++ fast paths:
the whole file is scanned with NumPy — newline offsets in a single pass,
sequence/quality lines sliced by offset arithmetic — with no per-read
Python loop on the hot path.  The writer exploits the invariant that ONLY
quality strings change: output = input buffer with the quality-line byte
ranges overwritten, so names/sequences/comments are byte-identical by
construction.

A ``*.gz`` output is written as one standard gzip member (mtime 0, so the
same input gives the same bytes); the JAX package writes BGZF blocks, which
decompress to the same FASTQ.
"""

from __future__ import annotations

import dataclasses
import gzip
import os

import numpy as np

from ..constants import PHRED_OFFSET
from ..oracle.kmers import _ENCODE_LUT  # shared bit-exact encode LUT

_NL = 10  # ord('\n')
_ROW_CHUNK = 65536  # rows per gather/scatter step: bounds the index temporaries
_GZIP_LEVEL = 6


@dataclasses.dataclass
class FastqData:
    """Parsed FASTQ: flat buffer + per-record offsets (zero-copy slices).

    seq_starts[i]:seq_ends[i] and qual_starts[i]:qual_ends[i] index into
    `buf`.  Record i's name line is name_starts[i]:name_ends[i] (without
    the leading '@' or trailing newline).
    """

    buf: np.ndarray          # uint8 [filesize]
    name_starts: np.ndarray  # int64 [N]
    name_ends: np.ndarray
    seq_starts: np.ndarray
    seq_ends: np.ndarray
    qual_starts: np.ndarray
    qual_ends: np.ndarray

    @property
    def num_reads(self) -> int:
        return int(self.name_starts.shape[0])

    @property
    def lengths(self) -> np.ndarray:
        return self.seq_ends - self.seq_starts

    @property
    def max_len(self) -> int:
        return int(self.lengths.max()) if self.num_reads else 0

    def seq_bytes(self, i: int) -> bytes:
        return self.buf[self.seq_starts[i]:self.seq_ends[i]].tobytes()

    def qual_bytes(self, i: int) -> bytes:
        return self.buf[self.qual_starts[i]:self.qual_ends[i]].tobytes()

    def name_bytes(self, i: int) -> bytes:
        return self.buf[self.name_starts[i]:self.name_ends[i]].tobytes()

    def seconds_mask(self) -> np.ndarray:
        """Second-in-pair per DECISIONS.md D11: name (sans comment) ends '/2'.

        Vectorized: the name's first token ends at the first whitespace
        byte of the name line, found by one searchsorted over the
        whitespace positions of the buffer.  Names that START with
        whitespace (where ``bytes.split`` skips it) take the per-record
        loop, as does nothing else.
        """
        n = self.num_reads
        out = np.zeros(n, dtype=bool)
        if n == 0:
            return out
        buf = self.buf
        s, e = self.name_starts, self.name_ends
        is_ws = (buf == 32) | ((buf >= 9) & (buf <= 13))
        ws = np.flatnonzero(is_ws)
        first = np.searchsorted(ws, s)
        tok_end = np.where(first < ws.size,
                           ws[np.minimum(first, ws.size - 1)], buf.size)
        tok_end = np.minimum(tok_end, e)
        ok = tok_end - s >= 2
        i2 = np.where(ok, tok_end - 2, 0)
        i1 = np.where(ok, tok_end - 1, 0)
        out = ok & (buf[i2] == ord("/")) & (buf[i1] == ord("2"))
        odd = np.flatnonzero((e > s) & is_ws[np.minimum(s, buf.size - 1)])
        for i in odd:
            tok = buf[int(s[i]):int(e[i])].tobytes().split()
            out[i] = bool(tok) and tok[0].endswith(b"/2")
        return out


def _load_bytes(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            data = gzip.decompress(f.read())
        else:
            data = f.read()
    return np.frombuffer(data, dtype=np.uint8).copy()


def parse_fastq_bytes(data: bytes | np.ndarray) -> FastqData:
    if isinstance(data, (bytes, bytearray)):
        buf = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    else:
        buf = np.asarray(data, dtype=np.uint8)
    if buf.size and buf[-1] != _NL:
        buf = np.concatenate([buf, np.array([_NL], dtype=np.uint8)])

    nl = np.flatnonzero(buf == _NL)
    if nl.size % 4 != 0:
        raise ValueError(
            f"FASTQ parse error: {nl.size} lines is not a multiple of 4")
    n = nl.size // 4
    line_starts = np.concatenate([[0], nl[:-1] + 1]) if nl.size else nl
    line_ends = nl  # exclusive of newline
    ls = line_starts.reshape(n, 4) if n else line_starts.reshape(0, 4)
    le = line_ends.reshape(n, 4) if n else line_ends.reshape(0, 4)
    if n and not (buf[ls[:, 0]] == ord("@")).all():
        bad = int(np.flatnonzero(buf[ls[:, 0]] != ord("@"))[0])
        raise ValueError(f"FASTQ record {bad}: header does not start with '@'")
    if n and not ((le[:, 1] - ls[:, 1]) == (le[:, 3] - ls[:, 3])).all():
        bad = int(np.flatnonzero(
            (le[:, 1] - ls[:, 1]) != (le[:, 3] - ls[:, 3]))[0])
        raise ValueError(f"FASTQ record {bad}: seq/qual length mismatch")
    return FastqData(
        buf=buf,
        name_starts=ls[:, 0] + 1, name_ends=le[:, 0],
        seq_starts=ls[:, 1], seq_ends=le[:, 1],
        qual_starts=ls[:, 3], qual_ends=le[:, 3],
    )


def read_fastq(path: str) -> FastqData:
    return parse_fastq_bytes(_load_bytes(path))


def extract_padded_arrays(fq: FastqData, max_len: int | None = None):
    """Fixed-shape [N, Lmax] (codes int8, quals int8, mask bool) arrays.

    Vectorized: one fancy-gather per field using offset arithmetic, in row
    chunks so the index temporaries stay small; padding is code BASE_N /
    qual 0 / mask False.
    """
    n = fq.num_reads
    lens = fq.lengths.astype(np.int64)
    L = int(max_len or (lens.max() if n else 1) or 1)
    if n == 0:
        return (np.zeros((0, L), np.int8), np.zeros((0, L), np.int8),
                np.zeros((0, L), bool), lens)
    if int(lens.max(initial=0)) > L:
        raise ValueError(f"read length {int(lens.max())} exceeds max_len {L}")
    codes = np.empty((n, L), np.int8)
    quals = np.empty((n, L), np.int8)
    mask = np.empty((n, L), bool)
    pos = np.arange(L, dtype=np.int64)[None, :]
    last = fq.buf.size - 1
    for s in range(0, n, _ROW_CHUNK):
        e = min(n, s + _ROW_CHUNK)
        m = pos < lens[s:e, None]
        seq_idx = np.minimum(fq.seq_starts[s:e, None] + pos, last)
        c = _ENCODE_LUT[fq.buf[seq_idx]]
        codes[s:e] = np.where(m, c, np.int8(4))
        qual_idx = np.minimum(fq.qual_starts[s:e, None] + pos, last)
        q = fq.buf[qual_idx].astype(np.int16) - PHRED_OFFSET
        quals[s:e] = np.where(m, np.clip(q, 0, 93), 0).astype(np.int8)
        mask[s:e] = m
    return codes, quals, mask, lens


def is_gz_path(p) -> bool:
    """True for a path-like sink named *.gz — those outputs must be
    compressed, never plain bytes under a .gz name."""
    if isinstance(p, os.PathLike):
        p = os.fspath(p)
    if isinstance(p, bytes):
        return p.endswith(b".gz")
    return isinstance(p, str) and p.endswith(".gz")


class GzipFastqSink:
    """File-like sink that gzip-compresses everything written through it
    (one gzip member, mtime 0: the same bytes in give the same bytes out)."""

    def __init__(self, path):
        self.f = open(path, "wb")
        self.w = gzip.GzipFile(filename="", mode="wb", fileobj=self.f,
                               compresslevel=_GZIP_LEVEL, mtime=0)

    def write(self, data) -> None:
        self.w.write(bytes(data))

    def flush(self) -> None:
        self.w.flush()

    def close(self) -> None:
        self.w.close()
        self.f.close()


def open_fastq_sink(path):
    """Open a FASTQ output path: gzip-compressing sink for *.gz names,
    plain binary file otherwise."""
    return GzipFastqSink(path) if is_gz_path(path) else open(path, "wb")


def _write_out(buf: bytes, path_or_file) -> None:
    if isinstance(path_or_file, os.PathLike):
        path_or_file = os.fspath(path_or_file)
    if isinstance(path_or_file, (str, bytes)):
        sink = open_fastq_sink(path_or_file)
        try:
            sink.write(buf)
        finally:
            sink.close()
    else:
        path_or_file.write(buf)


def render_fastq_with_quals(fq: FastqData, new_quals: np.ndarray,
                            mask: np.ndarray) -> bytes:
    """The input FASTQ bytes with quality lines replaced (only-quals-
    change invariant) — the render half of write_fastq_with_quals."""
    out = fq.buf.copy()
    n = fq.num_reads
    if n:
        L = new_quals.shape[1]
        mask = np.asarray(mask)
        new_quals = np.asarray(new_quals)
        pos = np.arange(L, dtype=np.int64)[None, :]
        for s in range(0, n, _ROW_CHUNK):
            e = min(n, s + _ROW_CHUNK)
            m = mask[s:e]
            flat_idx = (fq.qual_starts[s:e, None] + pos)[m]
            flat_q = new_quals[s:e][m].astype(np.int16) + PHRED_OFFSET
            out[flat_idx] = flat_q.astype(np.uint8)
    return out.tobytes()


def write_fastq_with_quals(fq: FastqData, new_quals: np.ndarray,
                           mask: np.ndarray, path_or_file) -> None:
    """Write the input FASTQ with quality lines replaced.  new_quals:
    int [N, Lmax] phred values; mask: bool [N, Lmax].  A *.gz output
    path is gzip-compressed."""
    _write_out(render_fastq_with_quals(fq, new_quals, mask),
               path_or_file)

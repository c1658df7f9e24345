"""FASTQ reader/writer (plain, gzip or BGZF), native C++ on the hot path.

Counterpart of ``kbbq_tpu/io/fastq.py`` with its native fast paths: the
record walk with the second-in-pair flags (``parse_fastq_bytes``,
``FastqData.seconds_mask``), the padded-array decode
(``extract_padded_arrays``) and the quality write-back
(``render_fastq_with_quals``) run in the threaded host codec
(``io/native_lib.py``, ``csrc/kbbq_io.cc``), which is built at first use and
raises when it cannot be: nothing falls back.  Beside each is its NumPy
version (``*_plain``: newline offsets in one pass, fields sliced by offset
arithmetic), which the tests hold the codec against.  The writer exploits
the invariant that ONLY quality strings change: output = input buffer with
the quality bytes overwritten, so names/sequences/comments are
byte-identical by construction.

A ``*.gz`` output is BGZF at deflate level 2 (``io/bgzf.py``): the JAX
package's bytes.
"""

from __future__ import annotations

import dataclasses
import gzip
import os

import numpy as np

from ..constants import PHRED_OFFSET
from ..oracle.kmers import _ENCODE_LUT  # shared bit-exact encode LUT
from ..utils.mem import hugepage_empty
from . import bgzf, native_lib

_NL = 10  # ord('\n')
_ROW_CHUNK = 65536  # rows per gather/scatter step: bounds the index temporaries
_NAME_COLS = 128    # name bytes gathered per record by seconds_mask_plain


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
    # bool [N] second-in-pair flags of the native walk; None: not computed
    seconds: np.ndarray | None = None

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
        The native walk's flags (``parse_fastq_bytes``), else
        ``seconds_mask_plain``'s."""
        if self.seconds is not None:
            return self.seconds
        return self.seconds_mask_plain()

    def seconds_mask_plain(self) -> np.ndarray:
        """NumPy version of ``seconds_mask``.

        Vectorized over the name lines alone, in row chunks: the first
        ``_NAME_COLS`` bytes of every name are gathered, and the name's first
        token ends at its first whitespace byte (or at the name's end).
        Names whose first token runs past those columns, and names that
        START with whitespace (where ``bytes.split`` skips it), take the
        per-record loop.
        """
        n = self.num_reads
        out = np.zeros(n, dtype=bool)
        buf = self.buf
        cols = np.arange(_NAME_COLS)
        slow = []
        for a in range(0, n, _ROW_CHUNK):
            b = min(n, a + _ROW_CHUNK)
            s = self.name_starts[a:b]
            ln = self.name_ends[a:b] - s
            w = min(int(ln.max(initial=0)), _NAME_COLS)
            if w == 0:
                continue
            c = buf[np.minimum(s[:, None] + cols[:w], buf.size - 1)]
            ws = (cols[:w] < ln[:, None]) & ((c == 32) | ((c >= 9) & (c <= 13)))
            has = ws.any(axis=1)
            tok = np.where(has, ws.argmax(axis=1), ln)   # first token's end
            slow.append(a + np.flatnonzero((~has & (ln > w)) | ws[:, 0]))
            r = np.arange(b - a)
            ok = (tok >= 2) & (tok <= w)
            i2, i1 = np.where(ok, tok - 2, 0), np.where(ok, tok - 1, 0)
            out[a:b] = ok & (c[r, i2] == ord("/")) & (c[r, i1] == ord("2"))
        for i in np.concatenate(slow) if slow else ():
            tok = buf[self.name_starts[i]:self.name_ends[i]].tobytes().split()
            out[i] = bool(tok) and tok[0].endswith(b"/2")
        return out


def _load_bytes(path: str) -> np.ndarray:
    """The file's text as a writable uint8 array (gzip decompressed); a
    plain file is read straight into the array."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return np.frombuffer(gzip.decompress(f.read()),
                                 dtype=np.uint8).copy()
        buf = hugepage_empty(os.fstat(f.fileno()).st_size, np.uint8)
        return buf[:f.readinto(buf)]


def _as_buffer(data: bytes | np.ndarray) -> np.ndarray:
    """uint8 buffer of the FASTQ text, ending in a newline."""
    if isinstance(data, (bytes, bytearray)):
        buf = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    else:
        buf = np.asarray(data, dtype=np.uint8)
    if buf.size and buf[-1] != _NL:
        buf = np.concatenate([buf, np.array([_NL], dtype=np.uint8)])
    return buf


def parse_fastq_bytes(data: bytes | np.ndarray) -> FastqData:
    """Record offsets and second-in-pair flags of a FASTQ text by the
    native walk (threaded over byte ranges of the text).  Malformed
    input raises the plain version's ValueError (which names the fault);
    where the plain version accepts what the scanner refuses (a third line
    without its '+'), the scanner's own error, with the byte offset."""
    buf = _as_buffer(data)
    try:
        idx, seconds = native_lib.fastq_walk(buf)
    except ValueError as e:
        _parse_buffer_plain(buf)        # raises its own message
        raise ValueError(f"FASTQ parse error: {e}") from None
    return FastqData(
        buf=buf,
        name_starts=idx[:, 0], name_ends=idx[:, 1],
        seq_starts=idx[:, 2], seq_ends=idx[:, 3],
        qual_starts=idx[:, 6], qual_ends=idx[:, 7], seconds=seconds,
    )


def parse_fastq_bytes_plain(data: bytes | np.ndarray) -> FastqData:
    """NumPy version of ``parse_fastq_bytes``."""
    return _parse_buffer_plain(_as_buffer(data))


def _parse_buffer_plain(buf: np.ndarray) -> FastqData:
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


def _extract_shape(fq: FastqData, max_len: int | None):
    n = fq.num_reads
    lens = fq.lengths.astype(np.int64)
    L = int(max_len or (lens.max() if n else 1) or 1)
    if int(lens.max(initial=0)) > L:
        raise ValueError(f"read length {int(lens.max())} exceeds max_len {L}")
    return n, L, lens


def extract_padded_arrays(fq: FastqData, max_len: int | None = None):
    """Fixed-shape [N, Lmax] (codes int8, quals int8, mask bool) arrays and
    the read lengths int64 [N], decoded by the native codec in one threaded
    pass into huge-page buffers; padding is code BASE_N / qual 0 / mask
    False.  `mask` is the codec's uint8 array viewed as bool."""
    n, L, lens = _extract_shape(fq, max_len)
    codes = hugepage_empty((n, L), np.int8)
    quals = hugepage_empty((n, L), np.int8)
    mask = hugepage_empty((n, L), np.uint8)
    if n:
        native_lib.fastq_extract(fq.buf, fq.seq_starts, fq.qual_starts, lens,
                                 L, _ENCODE_LUT, codes, quals, mask)
    return codes, quals, mask.view(bool), lens


def extract_padded_arrays_plain(fq: FastqData, max_len: int | None = None):
    """NumPy version of ``extract_padded_arrays``: one fancy-gather per
    field using offset arithmetic, in row chunks so the index temporaries
    stay small."""
    n, L, lens = _extract_shape(fq, max_len)
    if n == 0:
        return (np.zeros((0, L), np.int8), np.zeros((0, L), np.int8),
                np.zeros((0, L), bool), lens)
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
    """File-like sink that BGZF-compresses everything written through it
    (``bgzf.BGZFStreamWriter`` at level 2: the bytes of ``bgzf.compress``
    of all that was written, so of the in-memory writer too)."""

    def __init__(self, path):
        self.f = open(path, "wb")
        self.w = bgzf.BGZFStreamWriter(self.f)

    def write(self, data) -> None:
        self.w.write(data)

    def flush(self) -> None:
        pass                      # blocks are cut by size; close ends them

    def close(self) -> None:
        try:
            self.w.close()
        finally:
            self.f.close()


def open_fastq_sink(path):
    """Open a FASTQ output path: BGZF-compressing sink for *.gz names,
    plain binary file otherwise."""
    return GzipFastqSink(path) if is_gz_path(path) else open(path, "wb")


def _write_out(buf: bytes, path_or_file) -> None:
    if isinstance(path_or_file, os.PathLike):
        path_or_file = os.fspath(path_or_file)
    if isinstance(path_or_file, (str, bytes)):
        if is_gz_path(path_or_file):
            buf = bgzf.compress(buf)
        with open(path_or_file, "wb") as f:
            f.write(buf)
    else:
        path_or_file.write(buf)


def render_fastq_with_quals(fq: FastqData, new_quals: np.ndarray,
                            mask: np.ndarray) -> bytes:
    """The input FASTQ bytes with quality lines replaced (only-quals-
    change invariant) — the render half of write_fastq_with_quals — by the
    native write-back.  `mask` is the prefix mask of
    ``extract_padded_arrays`` (row i true on its first len_i columns, as on
    every path of the port), so each record's whole quality line is taken
    from the first len_i entries of its row."""
    mask = np.asarray(mask)
    if mask.shape != np.shape(new_quals) or mask.shape[0] != fq.num_reads:
        raise ValueError("new_quals and mask must be [N, L] of one shape")
    out = fq.buf.copy()
    if fq.num_reads:
        native_lib.fastq_write_quals(out, fq.qual_starts, fq.lengths,
                                     new_quals)
    return out.tobytes()


def render_fastq_with_quals_plain(fq: FastqData, new_quals: np.ndarray,
                                  mask: np.ndarray) -> bytes:
    """NumPy version of ``render_fastq_with_quals``: a scatter of the
    masked entries, in row chunks."""
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
    int [N, Lmax] phred values; mask: bool [N, Lmax], the extract's.  A
    *.gz output path is BGZF-compressed (gzip-readable)."""
    _write_out(render_fastq_with_quals(fq, new_quals, mask),
               path_or_file)

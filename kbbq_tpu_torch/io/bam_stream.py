"""Streamed BAM: chunked reader and incremental writer (bounded memory).

Counterpart of ``kbbq_tpu/io/bam_stream.py`` for one process:
``BGZFStreamReader`` inflates BGZF members incrementally (whole members at
a time, through the threaded native codec), ``iter_bam_raw_chunks`` cuts the
decompressed stream into raw chunks of whole records, indexed in bulk by the
native codec (``kbbq_bam_offsets``), and ``BamStreamWriter`` writes a header
and then record bytes through ``io/bgzf.py::BGZFStreamWriter``, so host
memory is O(chunk) end to end and the output equals the whole-file
``serialize_bam`` byte for byte.

Not here: the member index and virtual-offset readers of multi-host runs
(``bgzf_member_index``, ``voffset_for``, ``open_bam_stream_at``,
``iter_bam_raw_chunks_range`` / ``_offsets``), which come with the
multi-host slice.
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_lib
from .bam import BAMError, bam_header_bytes, parse_bam_header
from .bgzf import BGZF_EOF, BGZFError, BGZFStreamWriter

DEFAULT_CHUNK_RECORDS = 1 << 16
_READ_BYTES = 8 << 20


class BGZFStreamReader:
    """Incremental BGZF decompressor over a binary file object."""

    def __init__(self, fileobj, read_bytes: int = 4 << 20):
        self.f = fileobj
        self.read_bytes = read_bytes
        self.comp = bytearray()     # undecoded compressed tail
        self.out = bytearray()      # decoded, unconsumed
        self.pos = 0                # read cursor into out (a front delete
        # per small read would move the whole buffer each time)
        self.eof = False
        self.consumed = 0           # uncompressed bytes handed out

    def _fill_comp(self) -> bool:
        b = self.f.read(self.read_bytes)
        if not b:
            self.eof = True
            return False
        self.comp += b
        return True

    def _decode_some(self) -> bool:
        """Inflate the whole BGZF members at the front of comp into out;
        True if there were any.  Member headers are walked to the last
        complete member, and that span goes through the threaded native
        codec in one call."""
        data = self.comp
        off = 0
        n = len(data)
        while n - off >= 18:
            if data[off:off + 28] == BGZF_EOF:
                off += 28
                continue
            id1, id2, cm, flg = data[off:off + 4]
            xlen = struct.unpack_from("<H", data, off + 10)[0]
            if (id1, id2, cm) != (31, 139, 8) or not flg & 4:
                raise BGZFError(f"not a BGZF block at stream offset {off}")
            xoff = off + 12
            bsize = None
            end = xoff + xlen
            while xoff + 4 <= end:
                si1, si2 = data[xoff], data[xoff + 1]
                slen = struct.unpack_from("<H", data, xoff + 2)[0]
                if (si1, si2) == (66, 67) and slen == 2:
                    bsize = struct.unpack_from("<H", data, xoff + 4)[0] + 1
                xoff += 4 + slen
            if bsize is None:
                raise BGZFError("missing BC subfield")
            if n - off < bsize:
                break  # need more compressed bytes
            off += bsize
        if off == 0:
            return False
        try:
            raw = native_lib.bgzf_decompress(memoryview(data)[:off])
        except ValueError as e:
            raise BGZFError(str(e)) from e
        self.out += raw
        del self.comp[:off]
        return True

    def read(self, want: int) -> bytes:
        """Up to `want` decompressed bytes ('' only at EOF)."""
        while len(self.out) - self.pos < want and not self.eof:
            if not self._decode_some() and not self._fill_comp():
                break
        take = bytes(memoryview(self.out)[self.pos:self.pos + want])
        self.pos += len(take)
        self.consumed += len(take)
        if self.pos >= (1 << 20):
            del self.out[:self.pos]
            self.pos = 0
        return take

    def read_exact(self, want: int) -> bytes:
        b = self.read(want)
        if len(b) != want:
            raise BAMError("truncated BAM stream")
        return b


def open_bam_stream(path: str):
    """(header_text, refs, reader) with the reader positioned at the
    first alignment record."""
    f = open(path, "rb")
    try:
        r = BGZFStreamReader(f)
        # magic + l_text + text + refs, field by field through the stream
        magic = r.read_exact(4)
        l_text = struct.unpack("<i", r.read_exact(4))[0]
        text = r.read_exact(l_text)
        n_ref_b = r.read_exact(4)
        parts = [magic + struct.pack("<i", l_text) + text + n_ref_b]
        for _ in range(struct.unpack("<i", n_ref_b)[0]):
            lb = r.read_exact(4)
            parts.append(lb + r.read_exact(struct.unpack("<i", lb)[0] + 4))
        header_text, refs, _ = parse_bam_header(b"".join(parts))
    except BaseException:
        f.close()
        raise
    return header_text, refs, r


def _scan_record_index(buf, start: int):
    """(offs, sizes, end) of the complete records in buf[start:], by the
    native codec.  Raises BAMError on a block_size that is not positive."""
    try:
        return native_lib.bam_offsets(buf, start)
    except ValueError as e:
        raise BAMError(str(e)) from e


def _scan_record_index_plain(buf, start: int):
    """NumPy/Python version of ``_scan_record_index``: the same result."""
    offs, sizes = [], []
    off = start
    n = len(buf)
    while off + 4 <= n:
        size = int.from_bytes(bytes(buf[off:off + 4]), "little", signed=True)
        if size <= 0:
            raise BAMError(f"malformed BAM record size at byte {off}")
        if off + 4 + size > n:
            break
        offs.append(off + 4)
        sizes.append(size)
        off += 4 + size
    return np.asarray(offs, np.int64), np.asarray(sizes, np.int64), off


def _iter_raw_chunks_from_reader(reader, chunk_records: int):
    """Raw chunks of at most `chunk_records` whole records from an open
    reader: (buf uint8, offs, sizes) with offs[i] the i-th record BODY
    offset into buf and sizes[i] its body size.  Closes the reader's file
    at the end."""
    try:
        buf = bytearray()
        o_parts: list = []
        s_parts: list = []
        nrec = 0
        scanned = 0
        eof = False
        while True:
            while nrec < chunk_records and not eof:
                more = reader.read(_READ_BYTES)
                if not more:
                    eof = True
                    break
                buf += more
                o, s, scanned = _scan_record_index(buf, scanned)
                if o.size:
                    o_parts.append(o)
                    s_parts.append(s)
                    nrec += o.size
            if nrec == 0:
                if len(buf) - scanned:
                    raise BAMError("truncated BAM record")
                return
            offs = (np.concatenate(o_parts) if len(o_parts) > 1
                    else o_parts[0])
            sizes = (np.concatenate(s_parts) if len(s_parts) > 1
                     else s_parts[0])
            take = min(nrec, chunk_records)
            cut = int(offs[take - 1] + sizes[take - 1])
            yield (np.frombuffer(bytes(memoryview(buf)[:cut]), np.uint8),
                   offs[:take].copy(), sizes[:take].copy())
            rem_o, rem_s = offs[take:] - cut, sizes[take:]
            del buf[:cut]
            scanned -= cut
            o_parts = [rem_o] if rem_o.size else []
            s_parts = [rem_s] if rem_s.size else []
            nrec -= take
    finally:
        reader.f.close()


def iter_bam_raw_chunks(path: str,
                        chunk_records: int = DEFAULT_CHUNK_RECORDS):
    """(header_text, refs, iterator of (buf, offs, sizes)): raw chunks of
    at most `chunk_records` records, buf a uint8 array of concatenated raw
    records (block_size prefixes included), offs[i] the i-th record BODY
    offset into buf and sizes[i] its body size, so callers extract fields
    of a whole chunk with no per-record object."""
    header_text, refs, reader = open_bam_stream(path)
    return header_text, refs, _iter_raw_chunks_from_reader(reader,
                                                           chunk_records)


class BamStreamWriter:
    """Write a BAM incrementally: header once, then record bytes; blocks
    fall where ``serialize_bam`` puts them, so the file is the same."""

    def __init__(self, sink, header_text: str, refs):
        self._own = isinstance(sink, (str, bytes))
        self.f = open(sink, "wb") if self._own else sink
        self.w = BGZFStreamWriter(self.f)
        self.w.write(bam_header_bytes(header_text, refs))

    def write_raw(self, data) -> None:
        """Write record bytes (block_size prefixes included): a rewritten
        or verbatim raw chunk, as bytes or a uint8 array."""
        self.w.write(memoryview(data))

    def close(self) -> None:
        try:
            self.w.close()
        finally:
            if self._own:
                self.f.close()

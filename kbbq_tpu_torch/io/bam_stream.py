"""Streamed BAM: chunked reader and incremental writer (bounded memory).

Counterpart of ``kbbq_tpu/io/bam_stream.py`` for one process:
``BGZFStreamReader`` inflates BGZF members incrementally (whole members at
a time, through the threaded native codec), ``iter_bam_raw_chunks`` cuts the
decompressed stream into raw chunks of whole records, indexed in bulk by the
native codec (``kbbq_bam_offsets``), and ``BamStreamWriter`` writes a header
and then record bytes through ``io/bgzf.py::BGZFStreamWriter``, so host
memory is O(chunk) end to end and the output equals the whole-file
``serialize_bam`` byte for byte.

For several hosts (``parallel/multihost.py``): ``bgzf_member_index`` walks
the members' headers (no inflate), ``voffset_for`` maps an offset of the
decompressed stream to a (member, offset in it) virtual offset,
``iter_bam_raw_chunks_range`` reads a host's run of chunks from there,
``iter_bam_raw_chunks_offsets`` records where each chunk starts, and the
writer's ``write_header`` / ``write_eof`` switches make the parts that
``cat`` joins into one BAM.
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


def _iter_raw_chunks_from_reader(reader, chunk_records: int,
                                 max_records: int | None = None,
                                 offsets_into: list | None = None):
    """Raw chunks of at most `chunk_records` whole records from an open
    reader: (buf uint8, offs, sizes) with offs[i] the i-th record BODY
    offset into buf and sizes[i] its body size; `max_records` records at
    most in all; each chunk's start in the decompressed stream (the
    reader's ``consumed`` count) appended to `offsets_into`.  Closes the
    reader's file at the end."""
    try:
        buf = bytearray()
        o_parts: list = []
        s_parts: list = []
        nrec = 0
        scanned = 0
        eof = False
        remaining = max_records
        base_off = reader.consumed
        while True:
            while nrec < chunk_records and not eof and \
                    (remaining is None or nrec < remaining):
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
                if remaining:
                    raise BAMError(f"the BAM ended {remaining} record(s) "
                                   f"before the end of its range")
                return
            offs = (np.concatenate(o_parts) if len(o_parts) > 1
                    else o_parts[0])
            sizes = (np.concatenate(s_parts) if len(s_parts) > 1
                     else s_parts[0])
            take = min(nrec, chunk_records)
            if remaining is not None:
                take = min(take, remaining)
            cut = int(offs[take - 1] + sizes[take - 1])
            if offsets_into is not None:
                offsets_into.append(base_off)
            yield (np.frombuffer(bytes(memoryview(buf)[:cut]), np.uint8),
                   offs[:take].copy(), sizes[:take].copy())
            if remaining is not None:
                remaining -= take
                if remaining <= 0:
                    return
            base_off += cut
            rem_o, rem_s = offs[take:] - cut, sizes[take:]
            del buf[:cut]
            scanned -= cut
            o_parts = [rem_o] if rem_o.size else []
            s_parts = [rem_s] if rem_s.size else []
            nrec -= take
    finally:
        reader.f.close()


def bgzf_member_index(path: str):
    """([(compressed offset, decompressed offset)] per BGZF member, the
    decompressed size): a walk over the members' headers and ISIZE tails,
    one sequential read of the file in windows of 8 MiB, no inflate."""
    members = []
    uncomp = 0
    window = 8 << 20           # members are at most 64 KiB
    with open(path, "rb") as f:
        f.seek(0, 2)
        n = f.tell()
        buf = b""
        buf_start = 0          # file offset of buf[0]

        def ensure(start: int, need: int) -> bool:
            """Slide the window so that [start, start + need) is in buf."""
            nonlocal buf, buf_start
            if start >= buf_start and start + need <= buf_start + len(buf):
                return True
            if start + need > n:
                return False
            f.seek(start)
            buf = f.read(max(window, need))
            buf_start = start
            return len(buf) >= need

        off = 0
        while off + 18 <= n:
            if not ensure(off, 18):
                raise BGZFError("truncated member header")
            rel = off - buf_start
            id1, id2, cm, flg = buf[rel:rel + 4]
            xlen = struct.unpack_from("<H", buf, rel + 10)[0]
            if (id1, id2, cm) != (31, 139, 8) or not flg & 4:
                raise BGZFError(f"not a BGZF block at offset {off}")
            if not ensure(off, 12 + xlen):
                raise BGZFError("truncated member header")
            rel = off - buf_start
            xoff = rel + 12
            end = xoff + xlen
            bsize = None
            while xoff + 4 <= end:
                si1, si2 = buf[xoff], buf[xoff + 1]
                slen = struct.unpack_from("<H", buf, xoff + 2)[0]
                if (si1, si2) == (66, 67) and slen == 2:
                    bsize = struct.unpack_from("<H", buf, xoff + 4)[0] + 1
                xoff += 4 + slen
            if bsize is None or off + bsize > n:
                raise BGZFError("missing BC subfield / truncated member")
            if not ensure(off + bsize - 4, 4):
                raise BGZFError("truncated member")
            isize = struct.unpack_from("<I", buf,
                                       off + bsize - 4 - buf_start)[0]
            members.append((off, uncomp))
            uncomp += isize
            off += bsize
    return members, uncomp


def voffset_for(members, total_uncomp: int, stream_off: int):
    """(compressed offset of the member, offset into it) of the
    decompressed stream's offset `stream_off`."""
    import bisect
    if not 0 <= stream_off <= total_uncomp:
        raise BGZFError("stream offset out of range")
    i = bisect.bisect_right([u for _, u in members], stream_off) - 1
    comp_off, uncomp_off = members[i]
    return comp_off, stream_off - uncomp_off


def open_bam_stream_at(path: str, comp_off: int, delta: int
                       ) -> BGZFStreamReader:
    """A reader at the virtual offset (comp_off, delta): comp_off a
    member's start, delta landing on a record boundary."""
    f = open(path, "rb")
    try:
        f.seek(comp_off)
        r = BGZFStreamReader(f)
        while delta:
            got = r.read(min(delta, _READ_BYTES))
            if not got:
                raise BAMError("virtual offset past EOF")
            delta -= len(got)
    except BaseException:
        f.close()
        raise
    return r


def iter_bam_raw_chunks_range(path: str, comp_off: int, delta: int,
                              n_records: int,
                              chunk_records: int = DEFAULT_CHUNK_RECORDS):
    """Raw chunks (as ``iter_bam_raw_chunks``) of exactly `n_records`
    records from the record-boundary virtual offset (comp_off, delta): a
    host's run of chunks on several hosts."""
    reader = open_bam_stream_at(path, comp_off, delta)
    return _iter_raw_chunks_from_reader(reader, chunk_records,
                                        max_records=n_records)


def iter_bam_raw_chunks_offsets(path: str,
                                chunk_records: int = DEFAULT_CHUNK_RECORDS):
    """``iter_bam_raw_chunks`` that also records each chunk's start in the
    decompressed stream: (header_text, refs, chunks, offsets), offsets
    growing by one entry per chunk yielded."""
    header_text, refs, reader = open_bam_stream(path)
    offsets: list = []
    return header_text, refs, _iter_raw_chunks_from_reader(
        reader, chunk_records, offsets_into=offsets), offsets


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
    fall where ``serialize_bam`` puts them, so the file is the same.
    ``write_header=False`` / ``write_eof=False`` write a part with no
    header / no EOF marker (its last block flushed all the same): on
    several hosts host 0's part carries the header, the last host's the
    marker, and ``cat`` of the parts is one BAM."""

    def __init__(self, sink, header_text: str, refs,
                 write_header: bool = True, write_eof: bool = True):
        self._own = isinstance(sink, (str, bytes))
        self.f = open(sink, "wb") if self._own else sink
        self.w = BGZFStreamWriter(self.f)
        self._write_eof = write_eof
        if write_header:
            self.w.write(bam_header_bytes(header_text, refs))

    def write_raw(self, data) -> None:
        """Write record bytes (block_size prefixes included): a rewritten
        or verbatim raw chunk, as bytes or a uint8 array."""
        self.w.write(memoryview(data))

    def close(self) -> None:
        try:
            if self._write_eof:
                self.w.close()
            elif self.w.buf:                 # the last block, no marker
                self.w._emit(bytes(self.w.buf))
                self.w.buf.clear()
        finally:
            if self._own:
                self.f.close()

"""BGZF (blocked gzip): the codec of the port's ``.gz`` FASTQ outputs.

BGZF is a series of gzip members, each with a ``BC`` extra subfield that
gives the member's size, ending with a fixed 28-byte EOF marker; any gzip
reader reads it as one stream.  Counterpart of ``kbbq_tpu/io/bgzf.py``
(``decompress``, ``compress``, ``_compress_block``, ``is_bgzf``) and of
``BGZFStreamWriter`` in ``kbbq_tpu/io/bam_stream.py``: blocks of 0xff00
input bytes at deflate level ``DEFAULT_COMPRESS_LEVEL`` = 2, so a file
written here has the JAX package's bytes.

``compress`` and ``decompress`` run the threaded native codec
(``io/native_lib.py``); ``_compress_py`` is their plain version, one
``zlib.compressobj(level, DEFLATED, -15)`` per block, which is what the
native ``deflateInit2(level, Z_DEFLATED, -15, 8, default)`` does.
"""

from __future__ import annotations

import struct
import zlib

from . import native_lib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
BLOCK_SIZE = 0xFF00       # input bytes per block
MAX_BLOCK = 65536
# deflate level of every BGZF output (the JAX package's default: level 6
# ran at about a fifth of level 2's rate there for ~10 % smaller files)
DEFAULT_COMPRESS_LEVEL = 2


class BGZFError(ValueError):
    pass


def decompress(data) -> bytes:
    """Decompress a whole BGZF byte string (all blocks concatenated)."""
    try:
        return native_lib.bgzf_decompress(data)
    except ValueError as e:
        raise BGZFError(str(e)) from e


def compress(data, level: int = DEFAULT_COMPRESS_LEVEL) -> bytes:
    """Compress bytes into BGZF blocks + the EOF marker."""
    return native_lib.bgzf_compress(data, level)


def _compress_py(data: bytes, level: int = DEFAULT_COMPRESS_LEVEL) -> bytes:
    """Plain version of ``compress``: the same bytes, block by block."""
    out = [_compress_block(data[s:s + BLOCK_SIZE], level)
           for s in range(0, len(data), BLOCK_SIZE)]
    return b"".join(out) + BGZF_EOF


def _compress_block(chunk: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    bsize = len(cdata) + 12 + 6 + 8  # header + XLEN(6) + cdata + crc/isize
    if bsize > MAX_BLOCK:
        raise BGZFError("block too large after compression")
    hdr = struct.pack("<4BI2BH", 31, 139, 8, 4, 0, 0, 255, 6)
    extra = struct.pack("<2B2H", 66, 67, 2, bsize - 1)
    tail = struct.pack("<II", zlib.crc32(chunk), len(chunk))
    return hdr + extra + cdata + tail


def is_bgzf(head: bytes) -> bool:
    return (len(head) >= 18 and head[0] == 31 and head[1] == 139
            and head[2] == 8 and (head[3] & 4) != 0)


class BGZFStreamWriter:
    """Incremental BGZF compressor onto a binary file object.

    Collects `flush_bytes`, then deflates every whole block of it at once
    through the threaded native codec; blocks hold BLOCK_SIZE input bytes
    wherever the writes fall, so the output equals ``compress`` of all the
    bytes written.  ``close`` writes the tail and the one EOF marker.
    """

    def __init__(self, fileobj, level: int = DEFAULT_COMPRESS_LEVEL,
                 flush_bytes: int = 8 << 20):
        self.f = fileobj
        self.level = level
        self.flush_bytes = max(flush_bytes, BLOCK_SIZE)
        self.buf = bytearray()

    def _emit(self, span) -> None:
        # the codec ends every call with an EOF marker: one belongs at the
        # end of the file only
        self.f.write(memoryview(compress(span, self.level))[:-28])

    def write(self, data) -> None:
        self.buf += data
        if len(self.buf) >= self.flush_bytes:
            n = (len(self.buf) // BLOCK_SIZE) * BLOCK_SIZE
            span = bytes(self.buf[:n])
            del self.buf[:n]
            self._emit(span)

    def close(self) -> None:
        if self.buf:
            self._emit(bytes(self.buf))
            self.buf.clear()
        self.f.write(BGZF_EOF)

"""Build and ctypes binding of the host IO codec ``csrc/kbbq_io.cc``.

``build()`` compiles the codec with g++ into
``kbbq_tpu_torch/build/libkbbq_io.so`` at first use, and again when the
source is newer than the library; a build writes a temporary file and
renames it, so a concurrent build in another process never loads half a
library.  A failed build raises with the compiler's output: there is no
fallback.  The NumPy versions beside the callers (``io/fastq.py``'s and
``io/bam_vec.py``'s ``*_plain``, ``io/bam_stream.py``'s
``_scan_record_index_plain``, ``io/bgzf.py``'s ``_compress_py``,
``io/cram_codecs.py``'s ``rans_*_plain``) exist for the tests.

Counterpart of ``kbbq_tpu/io/native_lib.py`` for the functions the port
uses (the JAX package's copy of the library is never loaded).  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "kbbq_io.cc")
BUILD_DIR = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD_DIR, "libkbbq_io.so")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]
LD_FLAGS = ["-lz", "-pthread"]

_lib = None
build_log = ""       # the compiler's output of the last build
build_seconds = 0.0  # wall time of the last build, 0 when the library was fresh


def build() -> str:
    """Compile the codec if the library is missing or older than the
    source; returns the library's path.  Raises on a failed build."""
    global build_log, build_seconds
    if (os.path.isfile(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"C++ compiler {CXX!r} not found: the host IO "
                           f"codec of kbbq_tpu_torch ({SOURCE}) cannot be "
                           f"built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *LD_FLAGS]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.time() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{CXX} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, LIBRARY)   # atomic: a concurrent build never half-loads
    return LIBRARY


def _bind(lib) -> None:
    p, i32, i64, sz = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                       ctypes.c_size_t)
    lib.kbbq_bgzf_size.argtypes = [p, sz]
    lib.kbbq_bgzf_size.restype = i64
    lib.kbbq_bgzf_decompress.argtypes = [p, sz, p, sz, i32]
    lib.kbbq_bgzf_decompress.restype = i32
    lib.kbbq_bgzf_compress.argtypes = [p, sz, p, sz, i32, i32]
    lib.kbbq_bgzf_compress.restype = i64
    lib.kbbq_fastq_index.argtypes = [p, sz, p, sz]
    lib.kbbq_fastq_index.restype = i64
    lib.kbbq_fastq_extract.argtypes = [p, p, p, p, i64, i32, p, p, p, p, i32]
    lib.kbbq_fastq_extract.restype = None
    lib.kbbq_fastq_write_quals.argtypes = [p, p, p, p, i64, i32, i32]
    lib.kbbq_fastq_write_quals.restype = None
    lib.kbbq_bam_offsets.argtypes = [p, i64, i64, p, p, i64, p]
    lib.kbbq_bam_offsets.restype = i64
    lib.kbbq_bam_decode.argtypes = [p, p, p, p, i64, i32, i32, p, p, i64,
                                    i32]
    lib.kbbq_bam_decode.restype = None
    lib.kbbq_bam_write_quals.argtypes = [p, p, p, p, p, i64, i32, i32]
    lib.kbbq_bam_write_quals.restype = None
    lib.kbbq_bam_append_oq.argtypes = [p, p, p, p, p, p, p, p, i64, i32]
    lib.kbbq_bam_append_oq.restype = None
    lib.kbbq_rans_uncompress.argtypes = [p, i64, p, i64]
    lib.kbbq_rans_uncompress.restype = i32
    lib.kbbq_rans_compress.argtypes = [p, i64, i32, p, i64]
    lib.kbbq_rans_compress.restype = i64


def library():
    """The loaded codec (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        _bind(lib)
        _lib = lib
    return _lib


def default_threads() -> int:
    """Threads of every threaded codec call: all cores but one."""
    return max(1, (os.cpu_count() or 2) - 1)


def _u8(data) -> np.ndarray:
    """A contiguous uint8 view of bytes-like or array data (no copy where
    the data already is one)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return np.frombuffer(data, dtype=np.uint8)


def bgzf_decompress(data) -> bytes:
    """Decompress a whole BGZF stream (all blocks); ValueError when it is
    not one or a block fails its CRC."""
    src = _u8(data)
    lib = library()
    size = lib.kbbq_bgzf_size(src.ctypes.data, src.size)
    if size < 0:
        raise ValueError("native BGZF scan failed")
    out = np.empty(size, dtype=np.uint8)
    rc = lib.kbbq_bgzf_decompress(src.ctypes.data, src.size,
                                  out.ctypes.data, size, default_threads())
    if rc != 0:
        raise ValueError(f"native BGZF decompress failed (code {rc})")
    return out.tobytes()


def bgzf_compress(data, level: int) -> bytes:
    """BGZF blocks of 0xff00 input bytes each at deflate `level`, then the
    EOF marker."""
    src = _u8(data)
    cap = src.size + (src.size // 0xFF00 + 2) * 64 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = library().kbbq_bgzf_compress(src.ctypes.data, src.size,
                                     out.ctypes.data, cap, int(level),
                                     default_threads())
    if n < 0:
        raise ValueError(f"native BGZF compress failed ({n})")
    return out[:n].tobytes()


def fastq_index(buf: np.ndarray) -> np.ndarray:
    """int64 [N, 8] record offsets of a FASTQ buffer (uint8, ending in a
    newline).  Raises ValueError naming the byte offset of the first
    malformed record."""
    buf = _u8(buf)
    lib = library()
    n = lib.kbbq_fastq_index(buf.ctypes.data, buf.size, None, 0)
    if n < 0:
        raise ValueError(f"malformed FASTQ record at byte {-1 - n}")
    out = np.empty((int(n), 8), dtype=np.int64)
    lib.kbbq_fastq_index(buf.ctypes.data, buf.size, out.ctypes.data, int(n))
    return out


def fastq_extract(buf: np.ndarray, seq_starts: np.ndarray,
                  qual_starts: np.ndarray, lens: np.ndarray, stride: int,
                  enc_lut: np.ndarray, codes: np.ndarray, quals: np.ndarray,
                  mask: np.ndarray) -> None:
    """Decode records into the padded arrays codes, quals (int8) and mask
    (uint8), each C-contiguous [n, stride], written in full."""
    ss = np.ascontiguousarray(seq_starts, np.int64)
    qs = np.ascontiguousarray(qual_starts, np.int64)
    ln = np.ascontiguousarray(lens, np.int64)
    lut = np.ascontiguousarray(enc_lut, np.int8)
    n = ss.size
    if lut.size != 256 or qs.size != n or ln.size != n:
        raise ValueError("need a 256-entry table and one offset per record")
    for a, dt in ((codes, np.int8), (quals, np.int8), (mask, np.uint8)):
        if a.dtype != dt or a.shape != (n, stride) or \
                not a.flags.c_contiguous:
            raise ValueError(f"outputs must be C-contiguous {dt.__name__} "
                             f"[{n}, {stride}]")
    src = _u8(buf)
    if n and int(ln.max()) > stride:
        raise ValueError("a record is longer than the stride")
    if n and (min(int(ss.min()), int(qs.min()), int(ln.min())) < 0
              or int(max((ss + ln).max(), (qs + ln).max())) > src.size):
        raise ValueError("a record's bytes fall outside the buffer")
    library().kbbq_fastq_extract(
        src.ctypes.data, ss.ctypes.data, qs.ctypes.data, ln.ctypes.data,
        n, int(stride), lut.ctypes.data, codes.ctypes.data, quals.ctypes.data,
        mask.ctypes.data, default_threads())


def fastq_write_quals(out: np.ndarray, qual_starts: np.ndarray,
                      lens: np.ndarray, new_quals: np.ndarray) -> None:
    """Overwrite the quality bytes of `out` (uint8, C-contiguous, written
    in place): record i's lens[i] bytes from qual_starts[i] become
    new_quals[i, :lens[i]] + 33."""
    qs = np.ascontiguousarray(qual_starts, np.int64)
    ln = np.ascontiguousarray(lens, np.int64)
    q = np.ascontiguousarray(new_quals, np.int8)
    n = qs.size
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous uint8 array")
    if ln.size != n or q.ndim != 2 or q.shape[0] != n:
        raise ValueError("need one offset, length and row per record")
    if n and (int(ln.max()) > q.shape[1]
              or int((qs + ln).max()) > out.size):
        raise ValueError("a record's qualities fall outside the buffer")
    library().kbbq_fastq_write_quals(
        out.ctypes.data, qs.ctypes.data, ln.ctypes.data, q.ctypes.data, n,
        q.shape[1], default_threads())


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64).reshape(-1)


def _check_spans(starts: np.ndarray, lens, size: int, what: str) -> None:
    """Raise unless every [starts[i], starts[i] + lens[i]) lies in [0,
    size)."""
    if starts.size and (int(starts.min()) < 0 or int(np.min(lens)) < 0
                        or int((starts + lens).max()) > size):
        raise ValueError(f"a record's {what} fall outside the buffer")


def bam_offsets(buf, start: int = 0):
    """Index the complete BAM records of buf[start:] (uint8: block_size,
    body, block_size, body, ...) -> (offs, sizes, end): int64 body offsets
    and sizes, and the offset past the last complete record.  Raises
    ValueError naming the byte offset of a block_size that is not
    positive."""
    arr = _u8(buf)
    n = arr.size
    lib = library()
    offs_l, sizes_l = [], []
    end = ctypes.c_int64(start)
    while True:
        # a record holds at least 4 + 32 + 1 bytes; the loop takes the rest
        # of a buffer of smaller (malformed) records
        cap = max(1, (n - end.value) // 37 + 8)
        offs = np.empty(cap, np.int64)
        sizes = np.empty(cap, np.int64)
        cnt = lib.kbbq_bam_offsets(arr.ctypes.data, n, end.value,
                                   offs.ctypes.data, sizes.ctypes.data, cap,
                                   ctypes.byref(end))
        if cnt < 0:
            raise ValueError(f"malformed BAM record size at byte {-1 - cnt}")
        offs_l.append(offs[:cnt])
        sizes_l.append(sizes[:cnt])
        if cnt < cap:
            break
    if len(offs_l) == 1:
        return offs_l[0], sizes_l[0], int(end.value)
    return np.concatenate(offs_l), np.concatenate(sizes_l), int(end.value)


def bam_decode(buf, seq_off, qual_off, rev, L: int, oq_mode: bool,
               out_codes: np.ndarray, out_quals: np.ndarray) -> None:
    """Machine-order decode of records of one length L into the first L
    columns of out_codes and out_quals (int8, C-contiguous [n, stride >=
    L]): codes from the packed SEQ at seq_off, qualities from QUAL at
    qual_off (or, with oq_mode, an OQ value there), reversed and
    complemented where rev."""
    src = _u8(buf)
    so, qo = _i64(seq_off), _i64(qual_off)
    rv = np.ascontiguousarray(rev, np.uint8).reshape(-1)
    n = so.size
    if qo.size != n or rv.size != n or L < 0:
        raise ValueError("need one offset pair and strand per record")
    for a in (out_codes, out_quals):
        if a.dtype != np.int8 or a.ndim != 2 or a.shape[0] != n or \
                a.shape[1] < L or not a.flags.c_contiguous:
            raise ValueError(f"outputs must be C-contiguous int8 [{n}, >= "
                             f"{L}]")
    _check_spans(so, (L + 1) // 2, src.size, "sequence bytes")
    _check_spans(qo, L, src.size, "quality bytes")
    library().kbbq_bam_decode(
        src.ctypes.data, so.ctypes.data, qo.ctypes.data, rv.ctypes.data, n,
        int(L), 1 if oq_mode else 0, out_codes.ctypes.data,
        out_quals.ctypes.data, out_codes.shape[1], default_threads())


def bam_write_quals(out: np.ndarray, qual_off, lens, rev,
                    new_quals: np.ndarray) -> None:
    """Overwrite the QUAL fields of BAM records in `out` (uint8,
    C-contiguous, in place) from machine-order rows: record i's lens[i]
    bytes from qual_off[i] become new_quals[i, :lens[i]], reversed where
    rev[i]."""
    qo, ln = _i64(qual_off), _i64(lens)
    rv = np.ascontiguousarray(rev, np.uint8).reshape(-1)
    q = np.ascontiguousarray(new_quals, np.int8)
    n = qo.size
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous uint8 array")
    if ln.size != n or rv.size != n or q.ndim != 2 or q.shape[0] != n:
        raise ValueError("need one offset, length, strand and row per record")
    if n and int(ln.max()) > q.shape[1]:
        raise ValueError("a record is longer than its row of qualities")
    _check_spans(qo, ln, out.size, "qualities")
    library().kbbq_bam_write_quals(out.ctypes.data, qo.ctypes.data,
                                   ln.ctypes.data, rv.ctypes.data,
                                   q.ctypes.data, n, q.shape[1],
                                   default_threads())


def bam_append_oq(wbuf: np.ndarray, orig: np.ndarray, offs, sizes, qual_off,
                  oq_len) -> np.ndarray:
    """Records of `wbuf` (block_size prefixes included, body offsets `offs`)
    copied back to back into a new uint8 array, each record with
    oq_len[i] >= 0 followed by an OQ:Z tag holding orig[qual_off[i] ..
    + oq_len[i]] + 33 and its block_size grown to match."""
    wb, og = _u8(wbuf), _u8(orig)
    of, sz, qo, ol = _i64(offs), _i64(sizes), _i64(qual_off), _i64(oq_len)
    n = of.size
    if sz.size != n or qo.size != n or ol.size != n:
        raise ValueError("need one offset, size and OQ length per record")
    _check_spans(of - 4, sz + 4, wb.size, "bytes")
    grow = np.where(ol >= 0, ol + 4, 0)
    has = ol >= 0
    _check_spans(qo[has], ol[has], og.size, "qualities")
    seg = sz + 4 + grow
    dst = np.zeros(n, np.int64)
    if n > 1:
        np.cumsum(seg[:-1], out=dst[1:])
    out = np.empty(int(seg.sum()), np.uint8)
    library().kbbq_bam_append_oq(wb.ctypes.data, og.ctypes.data,
                                 of.ctypes.data, sz.ctypes.data,
                                 qo.ctypes.data, ol.ctypes.data,
                                 dst.ctypes.data, out.ctypes.data, n,
                                 default_threads())
    return out


def rans_uncompress(blob, n_out: int) -> bytes:
    """Decode a CRAM rANS 4x8 blob (order 0 or 1, from its header) of
    `n_out` bytes.  ValueError when the blob is malformed or declares
    another size."""
    src = _u8(blob)
    if n_out < 0:
        raise ValueError("rANS: negative output size")
    out = np.empty(n_out, np.uint8)
    rc = library().kbbq_rans_uncompress(src.ctypes.data, src.size,
                                        out.ctypes.data, int(n_out))
    if rc != 0:
        raise ValueError(f"rANS: malformed blob (native rc={rc})")
    return out.tobytes()


def rans_compress(data, order: int) -> bytes:
    """Encode bytes as a CRAM rANS 4x8 blob of order 0 or 1."""
    if order not in (0, 1):
        raise ValueError(f"rANS: unknown order {order}")
    src = _u8(data)
    n = src.size
    # tables (order 1: at most 257 x 770 B) + states + stream + header
    cap = n + (n >> 4) + (1 << 20)
    out = np.empty(cap, np.uint8)
    size = library().kbbq_rans_compress(src.ctypes.data, n, int(order),
                                        out.ctypes.data, cap)
    if size < 0:
        raise ValueError(f"rANS: compress failed (native rc={size})")
    return out[:size].tobytes()

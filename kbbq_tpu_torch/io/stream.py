"""Bounded-memory FASTQ input: chunked reads and the scan pass.

Counterpart of ``kbbq_tpu/io/stream.py`` (``_open_stream``,
``iter_fastq_chunks``, ``FastqScan``, ``scan_fastq_files``,
``chunk_to_batch_arrays``, ``prefetch_iter``) without ``StreamingBatches``
and ``_slice_batches``, which feed the JAX package's per-batch pipelines:

- ``iter_fastq_chunks``: records in chunks of at most ``chunk_reads``, from
  plain or gzip FASTQ, partial records carried across file blocks, so host
  memory is O(chunk), not O(file);
- ``scan_fastq_files``: the metadata pass (read and base counts, max length,
  k-mer windows, a CRC32 of every file's text) that filter sizing, the
  window shape and checkpoint fingerprints need before pass 1;
- ``chunk_to_batch_arrays``: one chunk's padded arrays, read group,
  global ordinals and read lengths;
- ``prefetch_iter``: a depth-bounded background thread in front of an
  iterator, so host decode overlaps the card's work.
"""

from __future__ import annotations

import dataclasses
import gzip
import queue
import threading
import zlib
from typing import Iterable, Iterator

import numpy as np

from ..utils.trace import OFF
from .fastq import FastqData, extract_padded_arrays, parse_fastq_bytes

DEFAULT_CHUNK_READS = 1 << 17       # 131,072 reads a chunk (~40 MB at 150 bp)
_BLOCK_BYTES = 8 << 20
_NL = 10


def _open_stream(path: str):
    f = open(path, "rb")
    head = f.read(2)
    f.seek(0)
    if head == b"\x1f\x8b":
        return gzip.open(f)
    return f


def iter_fastq_chunks(path: str,
                      chunk_reads: int = DEFAULT_CHUNK_READS,
                      block_bytes: int = _BLOCK_BYTES
                      ) -> Iterator[FastqData]:
    """Yield FastqData chunks of <= chunk_reads records each.

    Record boundaries are tracked by newline count (4 lines a record);
    partial records carry over between file blocks.  The live region is a
    list of blocks and an offset into the first, so each chunk is assembled
    with one copy and handed to the parser as the array it owns.
    """
    f = _open_stream(path)
    try:
        blocks: list[np.ndarray] = []
        head = 0                     # consumed prefix of blocks[0]
        live = 0                     # bytes in the live region
        nl = np.zeros(0, dtype=np.int64)   # newline offsets in it
        at_eof = False

        def cut_bytes(cut: int) -> np.ndarray:
            """Remove and return the live region's first `cut` bytes."""
            nonlocal head, live
            out = np.empty(cut, np.uint8)
            pos = 0
            while pos < cut:
                b = blocks[0]
                take_b = min(b.size - head, cut - pos)
                out[pos:pos + take_b] = b[head:head + take_b]
                pos += take_b
                head += take_b
                if head == b.size:
                    blocks.pop(0)
                    head = 0
            live -= cut
            return out

        while True:
            if not at_eof:
                block = f.read(block_bytes)
                if block:
                    arr = np.frombuffer(block, np.uint8)
                    nl = np.concatenate([nl, np.flatnonzero(arr == _NL)
                                         + live])
                    blocks.append(arr)
                    live += arr.size
                else:
                    at_eof = True
                    if live and blocks[-1][-1] != _NL:
                        blocks.append(np.frombuffer(b"\n", np.uint8))
                        nl = np.concatenate([nl, np.asarray([live])])
                        live += 1
            nrec = nl.size // 4
            if nrec >= chunk_reads or (at_eof and nrec > 0):
                take = min(chunk_reads, nrec)
                cut = int(nl[take * 4 - 1]) + 1
                yield parse_fastq_bytes(cut_bytes(cut))
                nl = nl[take * 4:] - cut
                continue
            if at_eof:
                if live and len(cut_bytes(live).tobytes().strip()):
                    raise ValueError(
                        f"{path}: truncated FASTQ record at EOF "
                        f"({nl.size} trailing lines)")
                return
    finally:
        f.close()


@dataclasses.dataclass
class FastqScan:
    """Metadata from the scan pass: per-file read and base counts and CRC32
    of the (decompressed) text, the longest read over all files (at least
    1), and the k-mer windows for the k it was scanned with."""
    per_file_reads: list
    per_file_bases: list
    max_len: int
    per_file_crc: list = dataclasses.field(default_factory=list)

    @property
    def num_reads(self) -> int:
        return int(sum(self.per_file_reads))

    @property
    def total_bases(self) -> int:
        return int(sum(self.per_file_bases))

    def total_kmers(self, k: int) -> int:
        return self._total_kmers[k]

    def __post_init__(self):
        self._total_kmers = {}


def scan_fastq_files(paths, k: int,
                     chunk_reads: int = DEFAULT_CHUNK_READS) -> FastqScan:
    """One streaming pass for (read counts, base counts, max_len, k-mer
    windows, per-file CRC32)."""
    per_reads, per_bases, per_crc = [], [], []
    max_len = 1
    tk = 0
    for p in paths:
        n = bases = crc = 0
        for fq in iter_fastq_chunks(p, chunk_reads):
            lens = fq.lengths
            n += fq.num_reads
            bases += int(lens.sum())
            crc = zlib.crc32(fq.buf, crc)   # the chunk's text, as read
            if fq.num_reads:
                max_len = max(max_len, int(lens.max()))
                tk += int(np.maximum(lens - k + 1, 0).sum())
        per_reads.append(n)
        per_bases.append(bases)
        per_crc.append(crc)
    scan = FastqScan(per_reads, per_bases, max_len, per_crc)
    scan._total_kmers[k] = tk
    return scan


def chunk_to_batch_arrays(fq: FastqData, max_len: int, rg: int,
                          start_ordinal: int, interleaved: bool):
    """(codes, quals, mask, rgs, seconds, ids, lens) of one chunk: padded
    [n, max_len] arrays and per-read read group, second-in-pair flag,
    global ordinal (uint32) and length (int64)."""
    codes, quals, mask, lens = extract_padded_arrays(fq, max_len)
    n = fq.num_reads
    rgs = np.full(n, rg, np.int32)
    if interleaved:
        # D11: the parity of the GLOBAL ordinal defines pairing
        seconds = np.arange(start_ordinal, start_ordinal + n) % 2 == 1
    else:
        seconds = fq.seconds_mask()
    ids = np.arange(start_ordinal, start_ordinal + n, dtype=np.uint32)
    return codes, quals, mask, rgs, seconds, ids, lens


def prefetch_iter(it: Iterable, depth: int = 2, trace=OFF) -> Iterator:
    """Run `it` in a daemon thread, buffering up to `depth` items; an
    exception in the thread is raised in the consumer.  A consumer that
    stops early leaves the thread blocked on the full queue until the
    process ends (it holds at most `depth` items).  On `trace`
    (``utils/trace.py``): a ``stream.read`` span on the thread around the
    making of each item and around the last call, which finds the end,
    its parent the consumer's span where the iteration began; and a
    ``stream.prefetch_wait`` span around each of the consumer's waits on
    the queue."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    parent = trace.current()
    it = iter(it)

    def worker():
        try:
            item = None
            while item is not end:
                with trace.span("stream.read", parent=parent):
                    item = next(it, end)
                q.put(item)
        except BaseException as e:  # handed to the consumer, raised there
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        with trace.span("stream.prefetch_wait"):
            item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item

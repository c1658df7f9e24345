"""Windowed single-device engine: out-of-core FASTQ and BAM, checkpoints.

Counterpart of ``kbbq_tpu/pipeline/stream_resident.py``
(``_HostChunkCache``, ``FastqWindowSource``, ``BamWindowSource``,
``StreamResidentEngine``, ``recalibrate_fastq_stream_resident``,
``recalibrate_bam_stream_resident``) and of the in-memory
``kbbq_tpu/pipeline/recalibrate.py::recalibrate_arrays``.  The input goes
through the card in WINDOWS of reads; every tensor of a window lives on the
card, and the passes run the resident path's kernels on it:

  pass 1  hash cache of the window + its sampled windows ORed into filter A
          (``bloom_or_words`` fused entry point, ``first_id`` = the window's
          global ordinal: sampling keys on global ordinals, DECISIONS D5,
          so the output does not depend on the window size)
  pass 2  re-hash (the fused entry point's hash-only mode), trust against A
          (``bloom_probe_trust``), filter B |= the trusted windows
          (``bloom_or_words``)
  pass 3  re-hash, initial trust against B (``bloom_probe``), the walk per
          65,536-row chunk (``walk_errors``), one covariate state on the
          device for all windows
  host    float64 delta math -> int8 Q' table
  pass 4  the device gather per window, back to the host; FASTQ windows are
          rendered, BAM chunks rewritten, by the native codec and written in
          order on one thread

No window's hash cache outlives its pass, so device memory is O(window +
filters).  When every window's tensors fit ``device_cache_bytes`` they are
kept on the card from pass 1 to pass 4; decoded FASTQ and BAM chunks are
kept on the host under ``host_cache_bytes``.  Neither changes a byte of
output.  A BAM window is one raw chunk of records (its primary records, at
the global ordinal of the first); the reference's ``rebuffer_windows``,
which re-cuts them into windows of one size for jit, has no use here.

Pass boundaries are checkpoints (``state/checkpoint.py``: the JAX package's
files), and a streamed FASTQ run into one plain file resumes pass 4 at the
chunk it had reached.

As a rank of a group the engine stages every L-th window of its source, L
the ranks of its host (on one host, the group's world; on several hosts,
``parallel/multihost.py``, each host's source is its own partition).  The
merges span the whole group.  With the
replicated layout its filters are merged at the pass boundaries; with the
hash-space-sharded layout (``parallel/sharded_bloom.py``) it holds its
shard of each filter, and every insert, word test and walk round is an
exchange with the other ranks.  Those are collectives, and ranks own
different numbers of windows, so the sharded passes step in lockstep
(``_steps``): every rank takes as many steps as the busiest rank has
windows, with an empty window where it has none left.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import resolve_device
from ..io.batcher import ReadArrays
from ..io.fastq import (is_gz_path, open_fastq_sink,
                        render_fastq_with_quals)
from ..io.stream import (
    DEFAULT_CHUNK_READS,
    chunk_to_batch_arrays,
    iter_fastq_chunks,
    prefetch_iter,
    scan_fastq_files,
)
from ..ops.bloom import bloom_or_words_into, bloom_query_words
from ..ops.covariate import accumulate_covariates, new_covariate_state
from ..ops.hash_cache import hash_cache_into, hash_windows
from ..ops.inference import infer_errors
from ..ops.trusted import trusted_from_cache
from ..oracle.bloom import check_layout_capacity
from ..oracle.covariate import CovariateTables
from ..oracle.gatk import build_recal_table
from ..oracle.kmers import alpha_threshold
from ..oracle.lighter import coverage_thresholds
from ..oracle.pipeline import bloom_params_for
from ..state.convert import bloom_from_numpy, bloom_to_numpy
from ..utils.trace import OFF, tracer
from .resident import (DEFAULT_CHUNK_ROWS, apply_table_on_device,
                       apply_table_tensor, arrays_to_device, to_host)

# decoded FASTQ chunks kept on the host across passes, at most (the JAX
# package's figure); a larger input re-reads its files every pass
DEFAULT_HOST_CACHE_BYTES = 8 << 30


class _HostChunkCache:
    """Memo of a window source's decoded chunks under a byte budget.  An
    input whose chunks exceed the budget drops the memo and re-reads its
    files every pass."""

    def __init__(self, budget: int):
        self.budget = budget
        self.items: list = []
        self.nbytes = 0
        self.complete = False
        self.enabled = budget > 0

    def restart(self) -> None:
        """A fresh stream begins: drop any partial fill."""
        if not self.complete:
            self.items.clear()
            self.nbytes = 0

    def add(self, item, nbytes: int) -> None:
        if not self.enabled or self.complete:
            return
        self.nbytes += int(nbytes)
        if self.nbytes > self.budget:
            self.items.clear()
            self.enabled = False
            return
        self.items.append(item)

    def finish(self) -> None:
        if self.enabled:
            self.complete = True


class FastqWindowSource:
    """Windows over FASTQ files: one window per chunk of `chunk_reads`
    records (a file's last chunk may be shorter; each file is its own read
    group, ordinals run on across files).  Items: (ordinal, arrays, file
    index, FastqData) with arrays = ``chunk_to_batch_arrays``'s.  `files`:
    the (file index, global ordinal of its first read) of the files to
    cover, by default every file in order; on several hosts, a host's own
    files at their canonical ordinals (``parallel/multihost.py``).  The
    read-ahead thread's spans go to `trace` (``io/stream.py::
    prefetch_iter``)."""

    def __init__(self, in_paths, scan, interleaved: bool, chunk_reads: int,
                 host_cache_bytes: int = DEFAULT_HOST_CACHE_BYTES,
                 files=None, trace=OFF):
        self.trace = trace
        self.in_paths = list(in_paths)
        self.scan = scan
        self.interleaved = interleaved
        self.chunk_reads = int(chunk_reads)
        self.num_rg = len(self.in_paths)
        if files is None:
            firsts = np.cumsum([0] + list(scan.per_file_reads))
            files = zip(range(self.num_rg), firsts)
        self.files = [(int(fi), int(o)) for fi, o in files]
        self.num_reads = sum(int(scan.per_file_reads[fi])
                             for fi, _ in self.files)
        self.max_len = scan.max_len
        self.total_bases = scan.total_bases
        self._cache = _HostChunkCache(host_cache_bytes)

    def total_kmers(self, k: int) -> int:
        return self.scan.total_kmers(k)

    def windows(self):
        if self._cache.complete:
            yield from self._cache.items
            return
        self._cache.restart()

        def parsed():
            # read + record scan on their own thread, beside the extract
            for fi, ordinal in self.files:
                for fq in iter_fastq_chunks(self.in_paths[fi],
                                            self.chunk_reads):
                    yield fi, ordinal, fq
                    ordinal += fq.num_reads

        for fi, ordinal, fq in prefetch_iter(parsed(), depth=2,
                                             trace=self.trace):
            arrs = chunk_to_batch_arrays(fq, self.max_len, fi, ordinal,
                                         self.interleaved)
            item = (ordinal, arrs, fi, fq)
            self._cache.add(item, fq.buf.nbytes
                            + sum(a.nbytes for a in arrs))
            yield item
        self._cache.finish()


class ArraysWindowSource:
    """Windows of `window_rows` rows over in-memory ReadArrays; row r has
    the global ordinal start_ordinal + r."""

    def __init__(self, arrays: ReadArrays, window_rows: int,
                 start_ordinal: int = 0):
        self.arrays = arrays
        self.window_rows = int(window_rows)
        self.start_ordinal = int(start_ordinal)
        self.num_rg = int(arrays.rgs.max(initial=0)) + 1
        self.num_reads = arrays.num_reads
        self.max_len = arrays.max_len
        self.lens = arrays.read_lengths()
        self.total_bases = int(self.lens.sum())

    def total_kmers(self, k: int) -> int:
        return int(np.maximum(self.lens - k + 1, 0).sum())

    def windows(self):
        a = self.arrays
        for s in range(0, a.num_reads, self.window_rows):
            e = min(a.num_reads, s + self.window_rows)
            arrs = (a.codes[s:e], a.quals[s:e], a.mask[s:e], a.rgs[s:e],
                    a.seconds[s:e], self.lens[s:e])
            yield self.start_ordinal + s, arrs, None, None


class BamWindowSource:
    """Windows over a BAM: one window per raw chunk of `chunk_records`
    records that holds a primary record, decoded by
    ``io/bam_vec.py::decode_machine_chunk``, at the global ordinal of its
    first primary record.  Items: (ordinal, decoded arrays, raws), raws the
    (buf, offs, sizes, decoded) of the window's chunk and of the chunks
    with no primary record around it (those before the first window go
    with it, the others with the window before them), so pass 4 writes
    every chunk of the file in order.  `span`: (compressed offset, offset
    into its BGZF member, records, global ordinal of the first primary) of
    a run of whole chunks to cover instead of the file (a host's range on
    several hosts, ``parallel/multihost.py``); `num_reads` is then the
    span's primaries.  `trace` (``utils/trace.py``) counts the records
    the first pass's decode sends down the per-record route
    (``bam.walk_refused``)."""

    def __init__(self, path: str, registry: dict, max_len: int,
                 num_reads: int, total_bases: int, total_kmers_: int,
                 use_oq: bool, chunk_records: int,
                 host_cache_bytes: int = DEFAULT_HOST_CACHE_BYTES,
                 span=None, trace=OFF):
        self.path = path
        self.span = span
        self.trace = trace
        self.registry = registry
        self.num_rg = max(1, len(registry))
        self.max_len = max_len
        self.num_reads = num_reads
        self.total_bases = total_bases
        self._tk = total_kmers_
        self.use_oq = use_oq
        self.chunk_records = int(chunk_records)
        self._cache = _HostChunkCache(host_cache_bytes)

    def total_kmers(self, k: int) -> int:
        return self._tk

    def raw_chunks_decoded(self):
        """(buf, offs, sizes, decoded) per raw chunk, memoised under the
        host cache budget; inflate and record index run on their own
        thread."""
        if self._cache.complete:
            yield from self._cache.items
            return
        from ..io.bam_stream import (iter_bam_raw_chunks,
                                     iter_bam_raw_chunks_range)
        from ..io.bam_vec import decode_machine_chunk
        self._cache.restart()
        if self.span is None:
            _, _, chunks = iter_bam_raw_chunks(self.path, self.chunk_records)
        else:
            chunks = iter_bam_raw_chunks_range(self.path, *self.span[:3],
                                               self.chunk_records)
        # a chunk decoded again on a later pass is not counted again
        trace, self.trace = self.trace, OFF
        for buf, offs, sizes in prefetch_iter(chunks, depth=2):
            dec = decode_machine_chunk(buf, offs, sizes, self.max_len,
                                       self.registry, use_oq=self.use_oq,
                                       trace=trace)
            item = (buf, offs, sizes, dec)
            self._cache.add(item, buf.nbytes + sum(a.nbytes for a in dec))
            yield item
        self._cache.finish()

    def windows(self):
        pending: list = []      # chunks with no primary record, not yet placed
        held = None             # the last window, waiting for what follows it
        ordinal = 0 if self.span is None else int(self.span[3])
        for item in self.raw_chunks_decoded():
            prim = item[3][6]
            if not prim.size:
                (held[2] if held is not None else pending).append(item)
                continue
            if held is not None:
                yield held
            held = (ordinal, item[3][:6], pending + [item])
            pending = []
            ordinal += prim.size
        if held is not None:
            yield held


def default_device_cache_bytes(dev) -> int:
    """Half of the card's free memory when the engine starts; on the CPU the
    host cache's budget."""
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[0] // 2
    return DEFAULT_HOST_CACHE_BYTES


def window_arrays(arrs) -> ReadArrays:
    """The ReadArrays of a window's host arrays (codes, quals, mask, rgs,
    seconds, ..., lens): every window source puts the read lengths last."""
    return ReadArrays(*arrs[:5], lens=arrs[-1])


class StreamResidentEngine:
    """Per-window staging and the four passes over a window source.

    `source` gives num_rg, num_reads, max_len, total_bases,
    total_kmers(k) and a re-iterable windows() of items whose first two
    fields are the window's ordinal and host arrays (codes, quals, mask,
    rgs, seconds, ..., lens: ``window_arrays``); the rest is the source's
    own, for pass 4.  The
    copies to and from the card are spans of `trace` (``h2d.copy``,
    ``d2h.copy``)."""

    def __init__(self, source, config, dev, device_cache_bytes=None,
                 chunk_rows: int | None = None, rank=None,
                 layout: str = "replicated",
                 filter_names=("rows_a", "rows_b"), trace=OFF):
        self.source = source
        self.trace = trace
        # a rank of a process group (``parallel/mesh.py``): it stages every
        # L-th window (L = its host's ranks) and merges over the group at
        # every pass boundary, or with the "sharded" layout holds its shard
        # of each filter
        self.rank = rank
        self.sharded = layout == "sharded"
        # the checkpoint files of filters A and B
        self.filter_names = tuple(filter_names)
        self.config = config
        self.dev = dev
        self.L = source.max_len
        self.num_rg = source.num_rg
        self.rows = int(chunk_rows or DEFAULT_CHUNK_ROWS)
        k = config.k
        alpha, coverage = config.resolve_alpha(source.total_bases)
        self.threshold = int(alpha_threshold(alpha))
        self.t_table = torch.from_numpy(
            coverage_thresholds(alpha, k).astype(np.int32)).to(dev)
        if self.sharded:
            from ..parallel.sharded_bloom import sharded_params
            params_a, params_b = sharded_params(
                config, source.total_kmers(k), alpha, coverage, rank.world)
        else:
            params_a, params_b = bloom_params_for(
                config, source.total_kmers(k), alpha, coverage)
            for p in (params_a, params_b):
                # the device holds packed words only (m/8 bytes per filter)
                check_layout_capacity(p, 33, "single-device windowed",
                                      "lower the bits per key or split the "
                                      "input")
        self.la, self.lb = params_a.log2_m, params_b.log2_m
        self.filt_a = self.filt_b = self.tables = None
        # codes, quals, mask: 3 B per padded base; rgs 8 B, seconds 1 B a read
        budget = (default_device_cache_bytes(dev)
                  if device_cache_bytes is None else device_cache_bytes)
        local = rank.local_world if rank is not None else 1
        self._cache_on = -(-source.num_reads // local) * (3 * self.L + 9) \
            <= budget
        self._dev_cache: list = []
        self._cache_complete = False

    def _mine(self, i: int) -> bool:
        return (self.rank is None
                or i % self.rank.local_world == self.rank.local_rank)

    def _windows(self, host: bool = False, every: bool = False):
        """(ordinal, device tensors (codes, quals, mask, rgs, seconds),
        source item or None) per window of this rank; with `every`, every
        window in order, another rank's with None for its tensors.  Pass
        1's staged windows are kept when the device cache is on; a later
        pass replays them, re-reading the source only when it needs the
        host side (`host`) or every window."""
        replay = self._cache_complete
        if replay and not (host or every):
            for ordinal, w in self._dev_cache:
                yield ordinal, w, None
            return
        if not replay:
            self._dev_cache.clear()                # drop any partial fill
        mine = 0
        for i, item in enumerate(self.source.windows()):
            if not self._mine(i):
                if every:
                    yield item[0], None, item
                continue
            if replay:
                ordinal, w = self._dev_cache[mine]
                mine += 1
            else:
                w = arrays_to_device(window_arrays(item[1]), self.dev,
                                     self.trace)
                ordinal = item[0]
                if self._cache_on:
                    self._dev_cache.append((ordinal, w))
            yield ordinal, w, item
        if self._cache_on:
            self._cache_complete = True

    def _steps(self):
        """The sharded passes' lockstep: this rank's windows as
        ``_windows`` gives them, then None, until no rank has one left."""
        from ..parallel.sharded_bloom import agreed_max
        it = self._windows()
        while True:
            got = next(it, None)
            if not agreed_max(self.rank, got is not None):
                return
            yield got

    def _step_tensors(self, got):
        """A step's device tensors (codes, quals, mask, rgs, seconds), with
        no rows where the rank has no window."""
        if got is not None:
            return got[1]
        return (torch.empty((0, self.L), dtype=torch.int8, device=self.dev),
                None, None, None, None)

    def _or_merge(self, filt: torch.Tensor) -> torch.Tensor:
        if self.rank is None:
            return filt
        from ..parallel.merge import or_merge
        return or_merge(self.rank, filt)

    def _zeros(self, log2_m: int) -> torch.Tensor:
        return torch.zeros(1 << (log2_m - 5), dtype=torch.int32,
                           device=self.dev)

    def run_pass1(self) -> None:
        k, h = self.config.k, self.config.num_hashes
        if self.sharded:
            from ..ops.hash_cache import hash_keep
            from ..parallel.sharded_bloom import ShardedFilter
            filt = ShardedFilter(self.rank, self.la)
            for got in self._steps():
                codes = self._step_tensors(got)[0]
                filt.insert(*hash_keep(codes, got[0] if got else 0, k, h,
                                       self.threshold))
            self.filt_a = filt
            return
        filt = self._zeros(self.la)
        for ordinal, w, _ in self._windows():
            hash_cache_into(w[0], filt, ordinal, k, h, self.threshold)
        self.filt_a = self._or_merge(filt)

    def run_pass2(self) -> None:
        k, h = self.config.k, self.config.num_hashes
        if self.sharded:
            from ..ops.trusted import trusted_from_hits
            from ..parallel.sharded_bloom import ShardedFilter
            filt = ShardedFilter(self.rank, self.lb)
            for got in self._steps():
                h1, word = hash_windows(self._step_tensors(got)[0], k, h)
                trusted = trusted_from_hits(
                    self.filt_a.test(h1, word), word, self.t_table, k,
                    self.config.trust_threshold)
                filt.insert(h1, word, trusted)
            self.filt_b = filt
            return
        filt = self._zeros(self.lb)
        for _, w, _ in self._windows():
            h1, word = hash_windows(w[0], k, h)
            trusted = trusted_from_cache(self.filt_a, h1, word, self.t_table,
                                         k, self.config.trust_threshold)
            bloom_or_words_into(filt, h1, word, trusted)
        self.filt_b = self._or_merge(filt)

    def _pass3_sharded(self, cov: dict) -> None:
        k, h = self.config.k, self.config.num_hashes
        for got in self._steps():
            codes, quals, mask, rgs, seconds = self._step_tensors(got)
            h1, word = hash_windows(codes, k, h)
            tr0 = self.filt_b.test(h1, word)
            del h1, word
            # a walk per window (more than one for a window over
            # WALK_BLOCK_ROWS), as many on every rank: each is collective
            for bs, be, err in self.filt_b.walk_blocks(codes, tr0, k, h,
                                                       self.config.ext_cap):
                for s in range(bs, be, self.rows):
                    e = min(be, s + self.rows)
                    accumulate_covariates(cov, codes[s:e], quals[s:e],
                                          mask[s:e], rgs[s:e], seconds[s:e],
                                          err[s - bs:e - bs])

    def run_pass3(self) -> None:
        k, h = self.config.k, self.config.num_hashes
        cov = new_covariate_state(self.num_rg, self.L, self.dev)
        if self.sharded:
            self._pass3_sharded(cov)
        for _, (codes, quals, mask, rgs, seconds), _ in (
                () if self.sharded else self._windows()):
            h1, word = hash_windows(codes, k, h)
            tr0 = bloom_query_words(self.filt_b, h1, word)
            del h1, word
            for s in range(0, codes.shape[0], self.rows):
                e = min(codes.shape[0], s + self.rows)
                err = infer_errors(self.filt_b, codes[s:e], k, h,
                                   self.config.ext_cap, trusted0=tr0[s:e])
                accumulate_covariates(cov, codes[s:e], quals[s:e], mask[s:e],
                                      rgs[s:e], seconds[s:e], err)
        if self.rank is not None:
            from ..parallel.merge import sum_merge
            sum_merge(self.rank, cov)
        self.tables = CovariateTables(
            self.num_rg, self.L,
            *(to_host(cov[name], self.trace).numpy() for name in
              ("cyc_total", "cyc_errors", "din_total", "din_errors")))

    def run_passes_1_to_3(self, ckpt) -> np.ndarray:
        """Passes 1-3 (each loaded from `ckpt` where it holds the pass),
        then the Q' table, each a stage of the engine's tracer.  Of a
        group's ranks every one loads, rank 0 alone saves (the merged
        state, in the one-device files) and computes the table, which it
        broadcasts."""
        saves = ckpt if self.rank is None or self.rank.rank == 0 else None
        name_a, name_b = self.filter_names
        self.trace.stage("pass1")
        rows = ckpt.load_array(name_a) if ckpt else None
        if rows is not None:
            self.filt_a = self._load_filter(rows)
        else:
            self.run_pass1()
            if ckpt:
                self._save_filter(saves, name_a, self.filt_a)
        self.trace.stage("pass2")
        rows = ckpt.load_array(name_b) if ckpt else None
        if rows is not None:
            self.filt_b = self._load_filter(rows)
        else:
            self.run_pass2()
            if ckpt:
                self._save_filter(saves, name_b, self.filt_b)
        self.filt_a = None
        self.trace.stage("pass3")
        loaded = ckpt.load_covariates() if ckpt else None
        if loaded is not None:
            self.tables = loaded
        else:
            self.run_pass3()
            if saves:
                saves.save_covariates(self.tables)
        self.filt_b = None
        self.trace.stage("deltas")
        if self.rank is None:
            recal = build_recal_table(self.tables)
        else:
            from ..parallel.merge import broadcast_table
            recal = broadcast_table(
                self.rank, build_recal_table(self.tables)
                if self.rank.rank == 0 else None, self.num_rg, self.L)
        return recal

    def _load_filter(self, rows: np.ndarray):
        """A saved filter (uint32 [m/32]): the whole filter on the device,
        or with the sharded layout this rank's slice of it."""
        if self.sharded:
            from ..parallel.sharded_bloom import ShardedFilter
            return ShardedFilter.from_host(self.rank, rows)
        return bloom_from_numpy(rows, self.dev)

    def _save_filter(self, saves, name: str, filt) -> None:
        """Save a filter into `saves` (rank 0's checkpoint, None on the
        other ranks); the sharded layout's shards reach rank 0's host one
        at a time, every rank taking part."""
        host = filt.to_host() if self.sharded else (
            bloom_to_numpy(filt) if saves else None)
        if saves:
            saves.save_array(name, host)

    def gathered(self, recal: np.ndarray, host: bool = False,
                 every: bool = False):
        """Pass 4: (ordinal, new quals int8 [n, L] on the host, source item
        or None) per window of this rank.  With `every`, the host's local
        rank 0 gets every window of the source in order, another rank's rows
        sent by their owner (a point-to-point send of the gathered tensor),
        and the other ranks get nothing."""
        recal_dev = torch.from_numpy(np.ascontiguousarray(recal)).to(self.dev)
        if not every or self.rank is None:
            for ordinal, w, item in self._windows(host):
                yield ordinal, apply_table_on_device(
                    recal_dev, *w, self.rows, self.trace), item
            return
        import torch.distributed as dist
        me, local = self.rank.local_rank, self.rank.local_world
        leader = self.rank.leader
        for i, (ordinal, w, item) in enumerate(
                self._windows(host, every=me == 0)):
            if w is not None:
                nq = apply_table_tensor(recal_dev, *w, self.rows)
                if me:
                    dist.send(nq, leader)
                    continue
            else:
                nq = torch.empty((item[1][0].shape[0], self.L),
                                 dtype=torch.int8, device=self.dev)
                dist.recv(nq, leader + i % local)
            yield ordinal, to_host(nq, self.trace).numpy(), item


def recalibrate_arrays_windowed(arrays: ReadArrays, config,
                                start_ordinal: int = 0,
                                checkpoint_dir: str | None = None,
                                device=None, timings: dict | None = None,
                                chunk_rows: int | None = None
                                ) -> np.ndarray:
    """Full pipeline over in-memory arrays through the windowed engine ->
    new quals int8 [N, L]; windows of ``max(config.batch_size,
    DEFAULT_CHUNK_READS)`` rows.  Row r samples as global ordinal
    start_ordinal + r.  With checkpoint_dir, passes 1-3 are saved at their
    boundaries under ``run_fingerprint`` and a rerun resumes from the first
    pass not saved.  device=None means the CUDA device (raises without
    one)."""
    from ..state.checkpoint import Checkpoint, run_fingerprint

    dev = resolve_device(device)
    with tracer(timings, dev) as trace:
        trace.stage("setup")
        ckpt = None
        if checkpoint_dir:
            ckpt = Checkpoint(checkpoint_dir)
            ckpt.check_fingerprint(run_fingerprint(config, arrays))
        src = ArraysWindowSource(arrays, max(int(config.batch_size),
                                             DEFAULT_CHUNK_READS),
                                 start_ordinal)
        eng = StreamResidentEngine(src, config, dev, chunk_rows=chunk_rows,
                                   trace=trace)
        recal = eng.run_passes_1_to_3(ckpt)
        trace.stage("pass4")
        out = np.empty((arrays.num_reads, arrays.max_len), dtype=np.int8)
        for ordinal, nq, _ in eng.gathered(recal):
            s = ordinal - start_ordinal
            out[s:s + nq.shape[0]] = nq
        trace.stage(None)
        return out


def _open_sinks(out_paths, in_paths, done_chunks: int, p4):
    """(sinks, opened, single_sink): the pass-4 sinks (one, or one per
    input) and those this run opened.  A resumed single plain sink is
    truncated to the bytes checkpointed and continues there."""
    single_sink = not isinstance(out_paths, (list, tuple))
    opened: list = []
    if single_sink:
        if not isinstance(out_paths, (str, bytes)):
            return [out_paths], opened, True
        if done_chunks:
            f = open(out_paths, "r+b")
            f.truncate(int(p4["bytes"]))
            f.seek(int(p4["bytes"]))
        else:
            f = open_fastq_sink(out_paths)
        opened.append(f)
        return [f], opened, True
    if len(out_paths) != len(in_paths):
        raise ValueError("need one output per input (or one sink)")
    sinks = []
    try:
        for o in out_paths:
            if isinstance(o, (str, bytes)):
                f = open_fastq_sink(o)
                opened.append(f)
                sinks.append(f)
            else:
                sinks.append(o)
    except BaseException:
        for f in opened:
            f.close()
        raise
    return sinks, opened, False


def recalibrate_fastq_stream_resident(
        in_paths, out_paths, config, checkpoint_dir: str | None = None,
        interleaved: bool = False, chunk_reads: int = DEFAULT_CHUNK_READS,
        timings: dict | None = None, report_out: str | None = None,
        apply_report: str | None = None, device=None,
        host_cache_bytes: int = DEFAULT_HOST_CACHE_BYTES,
        device_cache_bytes: int | None = None) -> dict:
    """FASTQ -> FASTQ recalibration through the windowed engine, with host
    memory O(window) when the host cache is off or overflows; the output
    bytes equal ``recalibrate_fastq``'s for any `chunk_reads` (and the JAX
    package's streamed bytes).  Public as
    ``pipeline.recalibrate_fastq_streaming``.

    Output semantics as ``recalibrate_fastq``: a single path or writable is
    one concatenated sink, a list one output per input.  Interleaved
    pairing takes the parity of the global ordinal across files (the JAX
    package's streamed rule).  report_out / apply_report as in
    ``recalibrate_fastq``.  checkpoint_dir: pass-boundary checkpoints under
    ``stream_fingerprint`` (with chunk_reads and interleaved); into one
    plain output file pass 4 is written synchronously and resumes at the
    chunk recorded in ``meta["pass4"]`` (a ``.gz`` sink restarts pass 4).
    host_cache_bytes: decoded chunks kept on the host across passes (0:
    re-read the files every pass); device_cache_bytes: the budget under
    which every window's tensors stay on the card from pass 1 to pass 4
    (default: half its free memory).  `timings` gets per-stage seconds
    and, on a card, peak device bytes (scan, setup, pass1-4, deltas), and
    the spans of ``utils/trace.py``: the copies, ``stream.read`` on the
    read-ahead thread, ``stream.render`` on the writer thread, and the
    main thread's waits on them (``stream.prefetch_wait``,
    ``stream.writer_wait``).  device=None means the CUDA device (raises
    without one).
    """
    dev = resolve_device(device)
    if isinstance(in_paths, (str, bytes)):
        in_paths = [in_paths]
    with tracer(timings, dev) as trace:
        trace.stage("scan")
        scan = scan_fastq_files(in_paths, config.k, chunk_reads)
        trace.stage("setup")
        check_fastq_checkpoint(checkpoint_dir, config, in_paths, scan,
                               chunk_reads, interleaved)
        return fastq_windowed_run(
            in_paths, out_paths, config, scan, checkpoint_dir, interleaved,
            chunk_reads, trace, report_out, apply_report, dev,
            host_cache_bytes, device_cache_bytes)


def check_fastq_checkpoint(checkpoint_dir, config, in_paths, scan,
                           chunk_reads: int, interleaved: bool) -> None:
    """Refuse a checkpoint of a streamed FASTQ run under other parameters
    or inputs (``stream_fingerprint`` with chunk_reads and interleaved);
    record the fingerprint on first use."""
    if not checkpoint_dir:
        return
    from ..state.checkpoint import Checkpoint, stream_fingerprint
    fp = stream_fingerprint(config, in_paths, scan)
    # pass 4 resumes by chunk, and pairing changes the covariates
    fp["chunk_reads"] = int(chunk_reads)
    fp["interleaved"] = bool(interleaved)
    Checkpoint(checkpoint_dir).check_fingerprint(fp)


def fastq_windowed_run(in_paths, out_paths, config, scan, checkpoint_dir,
                       interleaved: bool, chunk_reads: int, trace,
                       report_out, apply_report, dev, host_cache_bytes: int,
                       device_cache_bytes, rank=None,
                       layout: str = "replicated") -> dict:
    """The passes of ``recalibrate_fastq_stream_resident`` after its scan
    and fingerprint check, inside the ``setup`` stage of `trace`.  As a
    rank of a group (`rank`), the passes run on the rank's windows with
    the filters' `layout`, and rank 0 alone writes the report, the
    checkpoints and the output, every window in order."""
    from ..state.checkpoint import Checkpoint
    world = rank.world if rank is not None else 1
    writes = rank is None or rank.rank == 0
    src = FastqWindowSource(in_paths, scan, interleaved, chunk_reads,
                            host_cache_bytes // world, trace=trace)
    eng = StreamResidentEngine(src, config, dev, device_cache_bytes,
                               rank=rank, layout=layout, trace=trace)
    ckpt = Checkpoint(checkpoint_dir) if checkpoint_dir else None
    rg_names = [str(p) for p in in_paths]

    if apply_report is not None:
        from ..gatk_report import read_gatk_report, recal_table_from_report
        trace.stage("pass4")
        recal = recal_table_from_report(read_gatk_report(apply_report),
                                        rg_names, eng.L)
    else:
        recal = eng.run_passes_1_to_3(ckpt)
        trace.stage("pass4")
        if report_out is not None and writes:
            from ..gatk_report import write_gatk_report
            write_gatk_report(eng.tables, rg_names, report_out)
    stats = {"num_reads": scan.num_reads, "total_bases": scan.total_bases,
             "read_groups": eng.num_rg, "streamed": True,
             "engine": "resident-window"}
    if not writes:
        for _ in eng.gathered(recal, every=True):
            pass
        return stats

    # ---- pass 4: gather on the card, render + write in order on one thread
    p4 = ckpt.load_meta().get("pass4") if ckpt else None
    # a byte-offset resume needs one seekable plain sink; a .gz sink is a
    # compressed stream, so its pass 4 restarts from chunk 0
    resumable = (ckpt is not None and isinstance(out_paths, (str, bytes))
                 and not is_gz_path(out_paths))
    done_chunks = int(p4["chunks"]) if resumable and p4 else 0
    sinks, opened, single_sink = _open_sinks(out_paths, in_paths,
                                             done_chunks, p4)

    def render(fq, nq, mask, sink, parent):
        with trace.span("stream.render", parent=parent):
            sink.write(render_fastq_with_quals(fq, nq, mask))

    writer = ThreadPoolExecutor(1)
    pending: list = []
    chunk_idx = 0
    try:
        for _, nq, (_, arrs, fi, fq) in eng.gathered(recal, host=True,
                                                     every=True):
            if chunk_idx < done_chunks:
                chunk_idx += 1
                continue
            sink = sinks[0] if single_sink else sinks[fi]
            if resumable:
                sink.write(render_fastq_with_quals(fq, nq, arrs[2]))
                sink.flush()
                meta = ckpt.load_meta()
                meta["pass4"] = {"chunks": chunk_idx + 1,
                                 "bytes": sink.tell()}
                ckpt.save_meta(meta)
            else:
                if len(pending) >= 2:    # at most two windows wait to be written
                    with trace.span("stream.writer_wait"):
                        pending.pop(0).result()
                pending.append(writer.submit(render, fq, nq, arrs[2], sink,
                                             trace.current()))
            chunk_idx += 1
    finally:
        try:
            # every queued write, before the sinks close
            with trace.span("stream.writer_wait"):
                for f in pending:
                    f.result()
        finally:
            writer.shutdown(wait=True)
            for f in opened:
                f.close()
    return {**stats, "chunks": chunk_idx}


def recalibrate_bam_stream_resident(
        in_path: str, out_path, config, use_oq: bool = False,
        set_oq: bool = False, checkpoint_dir: str | None = None,
        chunk_records: int | None = None, timings: dict | None = None,
        report_out: str | None = None, apply_report: str | None = None,
        device=None, host_cache_bytes: int = DEFAULT_HOST_CACHE_BYTES,
        device_cache_bytes: int | None = None) -> dict:
    """BAM -> BAM recalibration through the windowed engine, host memory
    O(chunk) when the host cache is off or overflows: a scan pass
    (``pipeline/bam.py::scan_bam``), passes 1-3 per window on the card, and
    pass 4: the gather per window on the card, then the native rewrite of
    the window's raw chunk (``rewrite_quals_chunk``) and the BGZF write, in
    order, on one thread; chunks with no primary record are written as they
    are.  The output bytes equal ``recalibrate_bam``'s (and the JAX
    package's) for any `chunk_records` (default 65,536 records a window).

    checkpoint_dir: pass-boundary checkpoints under the JAX package's BAM
    fingerprint, so a directory written by either package resumes in the
    other (pass 4 always runs whole).  report_out / apply_report, use_oq /
    set_oq, host_cache_bytes / device_cache_bytes, timings and device as in
    ``recalibrate_bam`` and ``recalibrate_fastq_stream_resident``.
    """
    from ..io.bam_stream import DEFAULT_CHUNK_RECORDS
    from .bam import scan_bam

    dev = resolve_device(device)
    chunk_records = int(chunk_records or DEFAULT_CHUNK_RECORDS)
    with tracer(timings, dev) as trace:
        trace.stage("scan")
        scan = scan_bam(in_path, config.k, chunk_records)
        trace.stage("setup")
        check_bam_checkpoint(checkpoint_dir, config, scan, use_oq)
        return bam_windowed_run(in_path, out_path, config, scan, use_oq,
                                set_oq, checkpoint_dir, chunk_records, trace,
                                report_out, apply_report, dev,
                                host_cache_bytes, device_cache_bytes)


def check_bam_checkpoint(checkpoint_dir, config, scan, use_oq: bool) -> None:
    """Refuse a checkpoint of a streamed BAM run under other parameters or
    inputs (the JAX package's BAM fingerprint); record it on first use."""
    if not checkpoint_dir:
        return
    from ..state.checkpoint import Checkpoint, effective_ext_cap
    n, bases = scan[0], scan[1]
    Checkpoint(checkpoint_dir).check_fingerprint({
        "k": config.k, "alpha": config.alpha, "coverage": config.coverage,
        "genome_length": config.genome_length,
        "num_hashes": config.num_hashes,
        "trust_threshold": config.trust_threshold,
        "ext_cap": effective_ext_cap(config), "use_oq": use_oq,
        "num_reads": n, "total_bases": bases, "bam": True})


def bam_windowed_run(in_path: str, out_path, config, scan, use_oq: bool,
                     set_oq: bool, checkpoint_dir, chunk_records: int, trace,
                     report_out, apply_report, dev, host_cache_bytes: int,
                     device_cache_bytes, rank=None,
                     layout: str = "replicated") -> dict:
    """The passes of ``recalibrate_bam_stream_resident`` after its scan
    (`scan`: ``scan_bam``'s tuple) and fingerprint check, inside the
    ``setup`` stage of `trace`.  As a rank of a group (`rank`), the passes
    run on the rank's windows with the filters' `layout`, and rank 0 alone
    writes the report, the checkpoints and the output, every chunk in
    order."""
    from ..io.bam_stream import BamStreamWriter, open_bam_stream
    from ..state.checkpoint import Checkpoint
    from .bam import _registry_names

    world = rank.world if rank is not None else 1
    writes = rank is None or rank.rank == 0
    n, bases, tk, max_len, registry = scan
    src = BamWindowSource(in_path, registry, max_len, n, bases, tk, use_oq,
                          chunk_records, host_cache_bytes // world,
                          trace=trace)
    eng = StreamResidentEngine(src, config, dev, device_cache_bytes,
                               rank=rank, layout=layout, trace=trace)
    ckpt = Checkpoint(checkpoint_dir) if checkpoint_dir else None
    rg_names = _registry_names(registry)

    if apply_report is not None:
        from ..gatk_report import read_gatk_report, recal_table_from_report
        trace.stage("pass4")
        recal = recal_table_from_report(read_gatk_report(apply_report),
                                        rg_names, eng.L)
    else:
        recal = eng.run_passes_1_to_3(ckpt)
        trace.stage("pass4")
        if report_out is not None and writes:
            from ..gatk_report import write_gatk_report
            write_gatk_report(eng.tables, rg_names, report_out)
    stats = {"num_reads": n, "total_bases": bases, "read_groups": eng.num_rg,
             "streamed": True, "engine": "resident-window"}
    if not writes:
        for _ in eng.gathered(recal, every=True):
            pass
        return stats

    # ---- pass 4: gather on the card, rewrite + write in order on one thread
    header_text, refs, reader = open_bam_stream(in_path)
    reader.f.close()
    writer = BamStreamWriter(out_path, header_text, refs)
    windows = write_bam_windows(eng, recal, src, writer, set_oq)
    return {**stats, "windows": windows}


def write_bam_windows(eng, recal, src, writer, set_oq: bool) -> int:
    """Pass 4 of the windowed BAM route into `writer` (closed at the end):
    each window's gather on the card, then its raw chunks rewritten
    natively (those with no primary record as they are) and written in
    order on one thread; a source with no window writes every chunk as it
    is.  Returns the windows."""
    from ..io.bam_vec import rewrite_quals_chunk

    wex = ThreadPoolExecutor(1)
    pending: list = []

    def put(buf, offs, sizes, dec, nq):
        lens, prim = dec[5], dec[6]
        writer.write_raw(buf if nq is None else rewrite_quals_chunk(
            buf, offs, sizes, prim, lens, nq, set_oq=set_oq))

    windows = 0
    try:
        for _, nq, (_, _, raws) in eng.gathered(recal, host=True,
                                                every=True):
            windows += 1
            if len(pending) >= 2:     # at most two windows wait to be written
                pending.pop(0).result()
            for buf, offs, sizes, dec in raws:
                pending.append(wex.submit(put, buf, offs, sizes, dec,
                                          nq if dec[6].size else None))
        if not windows:                  # no primary record in the source
            for buf, offs, sizes, dec in src.raw_chunks_decoded():
                pending.append(wex.submit(put, buf, offs, sizes, dec, None))
    finally:
        try:
            for f in pending:     # every queued write, before the sink closes
                f.result()
        finally:
            wex.shutdown(wait=True)
            writer.close()
    return windows

"""Several hosts: one ``torch.distributed`` group over every host's cards.

Counterpart of ``kbbq_tpu/parallel/multihost.py`` (BASELINE config 5: a
whole genome streamed data-parallel over hosts).  Every host runs the same
call (``python -m kbbq_tpu_torch recalibrate ... --multihost``) over a
shared file system; ``init_multihost`` reads who it is from the launcher's
variables (``JAX_COORDINATOR``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``:
names of the launcher's contract, read here without JAX, so one launcher
drives both packages).  Each host:

- scans the whole input (deterministic, no communication) and takes its
  partition: FASTQ files by LPT on their read counts (``partition_inputs``),
  a BAM's contiguous run of raw chunks reached by a virtual offset
  (``partition_bam_chunks`` over ``scan_bam_multihost``), a CRAM's run of
  containers (the same partition over ``scan_cram_meta``);
- starts its L local ranks as ranks of ONE group of H x L
  (``mesh.launch`` with ``mesh.Hosts``); each rank runs the windowed engine
  (``pipeline/stream_resident.py``) on every L-th window of its host's
  partition, at the windows' global ordinals, so the filters and tables are
  the single host's (DECISIONS D5); the merges, the sharded filters' owners
  and their lockstep span the group, and a host with no window joins every
  collective with empty steps;
- writes its own outputs from its local rank 0: FASTQ, one output per
  input file it owns; BAM and CRAM, ``{out}.part-XXXX-of-YYYY``, host 0's
  part with the header, the last host's with the end marker, so ``cat`` of
  the parts is one file.  A BAM part flushes its own last BGZF block, so
  ``cat`` holds the single host's records, not its bytes; the CRAM parts of
  containers rewritten in place are the single host's bytes.

There is no new kernel: every rank launches the single-host entry points.
Checkpoints (shared directory, the JAX package's file names): the
replicated layout's filters from host 0 (``mh_rows_a`` / ``mh_rows_b``);
the sharded layout's as each host's part (``mh_sh_rows_*_host{h}``), then a
barrier over the group, then host 0 marks the pass; the covariates from
host 0; FASTQ pass 4 resumes per host from ``host{h}.json``.  A pass is
loaded only where every rank finds it marked (an all-reduce), so the ranks
always agree.  ``KBBQ_CRASH_POINT=pass2:<h>`` kills host h's ranks between
pass 1 and pass 2 (exit code 41), for the recovery tests.

Not ported: ``make_global_batch``, ``_local_shard_rows``, ``_empty_batch``
and the JAX placement of ``MultihostRecalPipeline``: they assemble JAX's
global arrays, where a rank here holds its own rows and ``agreed_max``
keeps the lockstep.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .mesh import Hosts, launch, slowest

CRASH_EXIT = 41          # the exit code of a host killed by KBBQ_CRASH_POINT


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> dict:
    """This host's place: ``process_id``, ``num_processes`` and the
    ``coordinator`` ("host:port" of the group's store, bound by host 0),
    each from the argument or else from ``JAX_PROCESS_ID``,
    ``JAX_NUM_PROCESSES`` and ``JAX_COORDINATOR`` (one process by default,
    which needs no coordinator)."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    num_processes = num_processes or int(
        os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not one of "
                         f"{num_processes} processes")
    if num_processes > 1 and not coordinator:
        raise ValueError("several processes need a coordinator: set "
                         "JAX_COORDINATOR=host:port (host 0's address)")
    return {"process_id": process_id, "num_processes": num_processes,
            "coordinator": coordinator}


@dataclasses.dataclass
class HostShard:
    """This host's files of the global read stream: paths [(path, global
    ordinal of its first read)], rg_ids (each file's index in the input,
    its read group) and read_counts, in input order.  A file keeps its
    canonical ordinal on any host, so the sampling, and the output, do not
    depend on the host count or the assignment."""
    paths: list
    start_ordinal: int
    rg_ids: list = dataclasses.field(default_factory=list)
    read_counts: list = dataclasses.field(default_factory=list)

    @property
    def total_reads(self) -> int:
        return int(sum(self.read_counts))


def partition_inputs(paths: list, read_counts: list, process_id: int,
                     num_processes: int) -> HostShard:
    """Greedy LPT by read count: the largest file first onto the least
    loaded host (ties: the lower file index, then the lower host), so every
    host computes the same assignment without communication."""
    if len(paths) != len(read_counts):
        raise ValueError("one read count per path")
    cum = [0]
    for n in read_counts:
        cum.append(cum[-1] + n)
    order = sorted(range(len(paths)), key=lambda i: (-read_counts[i], i))
    loads = [0] * num_processes
    assign: list[list[int]] = [[] for _ in range(num_processes)]
    for i in order:
        h = min(range(num_processes), key=lambda j: (loads[j], j))
        assign[h].append(i)
        loads[h] += read_counts[i]
    mine = sorted(assign[process_id])       # input order within the host
    return HostShard(paths=[(paths[i], cum[i]) for i in mine],
                     start_ordinal=cum[mine[0]] if mine else 0,
                     rg_ids=list(mine),
                     read_counts=[read_counts[i] for i in mine])


def host_steps_per_pass(read_counts_by_host, local_batch: int) -> int:
    """The busiest host's count of batches of `local_batch` reads (each
    file cut on its own): the windows a pass takes on that host.  The
    reference pads every host to it; here the ranks keep step through
    ``agreed_max``, so it only tells a launcher how long a pass runs."""
    def steps(counts):
        return sum((n + local_batch - 1) // local_batch for n in counts)
    return max((steps(c) for c in read_counts_by_host), default=0)


def scan_bam_multihost(path: str, k: int, chunk_records: int):
    """The scan every host runs alike: (header_text, refs, metas, registry,
    num_primary, total_bases, total_kmers, max_len), metas[i] =
    {"n_records", "n_primary", "ordinal" (primaries before chunk i),
    "stream_off" (the chunk's start in the decompressed stream)}."""
    from ..io.bam_stream import iter_bam_raw_chunks_offsets
    from ..io.bam_vec import scan_chunk

    header_text, refs, chunks, offsets = iter_bam_raw_chunks_offsets(
        path, chunk_records)
    metas = []
    registry: dict = {}
    n = bases = tk = 0
    max_len = 1
    for i, (buf, offs, sizes) in enumerate(chunks):
        cn, cb, ck, cl, keys = scan_chunk(buf, offs, sizes, k)
        metas.append({"n_records": int(offs.size), "n_primary": int(cn),
                      "ordinal": n, "stream_off": offsets[i]})
        n += cn
        bases += cb
        tk += ck
        max_len = max(max_len, cl)
        for key in keys:
            if key not in registry:
                registry[key] = len(registry)
    return header_text, refs, metas, registry, n, bases, tk, max_len


def partition_bam_chunks(metas, num_hosts: int):
    """Contiguous [(first, end)] runs of chunks (or containers), one per
    host, balanced by their primary records; deterministic."""
    total = sum(m["n_primary"] for m in metas)
    bounds = [0]
    acc = 0
    for h in range(1, num_hosts):
        target = total * h / num_hosts
        i = bounds[-1]
        while i < len(metas) and acc + metas[i]["n_primary"] <= target:
            acc += metas[i]["n_primary"]
            i += 1
        bounds.append(i)
    bounds.append(len(metas))
    return [(bounds[h], bounds[h + 1]) for h in range(num_hosts)]


def local_devices(devices: int | None, device_type: str) -> int:
    """Ranks on this host: `devices`, or (None or 0) every card; on the CPU
    one by default."""
    if devices:
        return int(devices)
    if device_type == "cuda":
        import torch
        return torch.cuda.device_count()
    return 1


def _layout(bloom_layout: str, config, total_bases: int, total_kmers: int,
            hosts: int, local: int) -> str:
    """``sharded.resolve_layout`` over the group of hosts x local ranks; the
    sharded layout needs a power-of-two group, refused before any rank
    starts."""
    from .sharded import resolve_layout
    layout = resolve_layout(bloom_layout, config, total_bases, total_kmers)
    world = hosts * local
    if layout == "sharded" and world & (world - 1):
        raise ValueError(
            f"the hash-space-sharded Bloom layout needs a power-of-two rank "
            f"count (each filter's m/32 words, a power of two, split evenly "
            f"over the ranks): got {hosts} host(s) x {local} rank(s) = "
            f"{world}")
    return layout


def _checkpoint(checkpoint_dir, apply_report, fp: dict, pid: int):
    """The run's ``Checkpoint`` (None without a directory or with
    apply_report), its fingerprint checked on every host and recorded by
    host 0 alone (two hosts renaming one ``meta.json.tmp`` would race)."""
    if not checkpoint_dir or apply_report is not None:
        return None
    from ..state.checkpoint import Checkpoint
    ckpt = Checkpoint(checkpoint_dir)
    ckpt.check_fingerprint(fp, record=pid == 0)
    return ckpt


def _maybe_crash(point: str, rank) -> None:
    """Failure injection for the recovery tests: ``KBBQ_CRASH_POINT=
    '<point>:<host>'`` kills every rank of that host at `point` (after its
    queued work, so it dies between passes, not inside a collective)."""
    if os.environ.get("KBBQ_CRASH_POINT") == f"{point}:{rank.host}":
        if rank.device.type == "cuda":
            import torch
            torch.cuda.synchronize(rank.device)
        os._exit(CRASH_EXIT)


def _all_marked(rank, ckpt, name: str) -> bool:
    """Every rank finds pass `name` marked done (an all-reduce: the ranks
    load or run it alike)."""
    from .sharded_bloom import agreed_max
    if ckpt is None:
        return False
    missing = name not in ckpt.load_meta()["passes_done"]
    return not agreed_max(rank, int(missing))


def _load_filter(eng, rank, ckpt, name: str):
    """A saved filter: whole on every rank (replicated), or this rank's
    slice of its host's part (sharded; the host's part is its ranks'
    shards in order, so any local rank count splits it)."""
    import torch

    from ..state.convert import bloom_from_numpy
    from .sharded_bloom import ShardedFilter
    if not eng.sharded:
        return bloom_from_numpy(ckpt.load_array(name), rank.device)
    part = ckpt.load_host_array(rank.host, name)
    S = part.shape[0] // rank.local_world
    mine = np.ascontiguousarray(
        part[rank.local_rank * S:(rank.local_rank + 1) * S], np.uint32)
    log2_m = (part.shape[0] * rank.hosts * 32).bit_length() - 1
    return ShardedFilter(rank, log2_m, torch.from_numpy(
        mine.view(np.int32).copy()).to(rank.device))


def _save_filter(eng, rank, ckpt, name: str, filt) -> None:
    """Replicated: host 0 saves the filter and marks it.  Sharded: each
    host's first rank gathers its ranks' shards and saves them as the
    host's part; after a barrier over the group host 0 marks the pass."""
    import torch
    import torch.distributed as dist

    from ..state.convert import bloom_to_numpy
    from .sharded_bloom import agreed_max
    if not eng.sharded:
        if rank.rank == 0:
            ckpt.save_array(name, bloom_to_numpy(filt))
        return
    if rank.local_rank:
        dist.send(filt.words, rank.leader)
    else:
        parts = [bloom_to_numpy(filt.words)]
        buf = torch.empty_like(filt.words)
        for r in range(1, rank.local_world):
            dist.recv(buf, rank.leader + r)
            parts.append(bloom_to_numpy(buf))
        ckpt.save_host_array(rank.host, name, np.concatenate(parts))
    agreed_max(rank, 0)              # every host's part is on disk
    if rank.rank == 0:
        ckpt.mark_pass(name)


def _run_passes(eng, rank, ckpt, mark, timings: dict) -> np.ndarray:
    """Passes 1-3 under the multi-host checkpoint protocol, then the Q'
    table (rank 0's delta math, broadcast); the sharded layout's shard
    sizes go to `timings` (``shard_words_a`` / ``_b``)."""
    from ..oracle.gatk import build_recal_table
    from .merge import broadcast_table

    names = (("mh_sh_rows_a", "mh_sh_rows_b") if eng.sharded
             else ("mh_rows_a", "mh_rows_b"))
    for name, run, attr, stage in ((names[0], eng.run_pass1, "filt_a",
                                    "pass1"),
                                   (names[1], eng.run_pass2, "filt_b",
                                    "pass2")):
        if _all_marked(rank, ckpt, name):
            setattr(eng, attr, _load_filter(eng, rank, ckpt, name))
        else:
            run()
            if ckpt:
                _save_filter(eng, rank, ckpt, name, getattr(eng, attr))
        if eng.sharded:
            timings["shard_words" + attr[-2:]] = int(
                getattr(eng, attr).words.numel())
        mark(stage)
        if stage == "pass1":
            _maybe_crash("pass2", rank)
    eng.filt_a = None
    if _all_marked(rank, ckpt, "covariates"):
        eng.tables = ckpt.load_covariates()
    else:
        eng.run_pass3()
        if ckpt and rank.rank == 0:
            ckpt.save_covariates(eng.tables)
    eng.filt_b = None
    mark("pass3")
    recal = broadcast_table(rank, build_recal_table(eng.tables)
                            if rank.rank == 0 else None, eng.num_rg, eng.L)
    mark("deltas")
    return recal


@dataclasses.dataclass
class _Job:
    """What every rank of a multi-host run needs: the format, the window
    source's arguments (less the host cache and its span), this host's
    span and outputs, and the run's parameters."""
    kind: str                   # "fastq", "bam" or "cram"
    source: tuple
    span: object
    out: object                 # FASTQ: every input's output; else the part
    config: object
    layout: str
    checkpoint_dir: str | None
    rg_names: list
    report_out: str | None
    apply_report: str | None
    header: tuple = ()          # BAM: (text, refs); CRAM: (text,)
    set_oq: bool = False


def _source(job: _Job, rank):
    """The window source of this rank's host (the default host cache split
    over the host's ranks)."""
    from ..pipeline.cram_stream import CramWindowSource
    from ..pipeline.stream_resident import (DEFAULT_HOST_CACHE_BYTES,
                                            BamWindowSource, FastqWindowSource)
    cache = DEFAULT_HOST_CACHE_BYTES // rank.local_world
    if job.kind == "fastq":
        return FastqWindowSource(*job.source, cache, files=job.span)
    if job.kind == "bam":
        return BamWindowSource(*job.source, cache, span=job.span)
    return CramWindowSource(*job.source, cache, span=job.span)


def _host_rank(rank, job: _Job):
    """One rank of a multi-host run -> (its stage timings, windows it
    wrote: the host's first rank, else 0)."""
    from ..io.bam_stream import BamStreamWriter
    from ..io.cram_write import CramStreamWriter
    from ..pipeline.cram_stream import write_cram_windows
    from ..pipeline.resident import StageClock
    from ..pipeline.stream_resident import (StreamResidentEngine,
                                            write_bam_windows)
    from ..state.checkpoint import Checkpoint

    timings: dict = {}
    clock = StageClock(timings, rank.device)
    src = _source(job, rank)
    eng = StreamResidentEngine(src, job.config, rank.device, rank=rank,
                               layout=job.layout)
    ckpt = (Checkpoint(job.checkpoint_dir)
            if job.checkpoint_dir and job.apply_report is None else None)
    clock.mark("setup")
    if job.apply_report is not None:       # no collective runs
        from ..gatk_report import read_gatk_report, recal_table_from_report
        recal = recal_table_from_report(read_gatk_report(job.apply_report),
                                        job.rg_names, eng.L)
    else:
        recal = _run_passes(eng, rank, ckpt, clock.mark, timings)
        if job.report_out is not None and rank.rank == 0:
            from ..gatk_report import write_gatk_report
            write_gatk_report(eng.tables, job.rg_names, job.report_out)
    last = rank.host == rank.hosts - 1
    if rank.local_rank:                  # the host's first rank writes
        for _ in eng.gathered(recal, every=True):
            pass
        windows = 0
    elif job.kind == "fastq":
        windows = _write_fastq(eng, recal, job, rank, ckpt)
    elif job.kind == "bam":
        windows = write_bam_windows(eng, recal, src, BamStreamWriter(
            job.out, *job.header, write_header=rank.host == 0,
            write_eof=last), job.set_oq)
    else:
        windows = write_cram_windows(eng, recal, src, CramStreamWriter(
            job.out, *job.header, write_header=rank.host == 0,
            write_eof=last))
    clock.mark("pass4")
    return timings, windows


def _write_fastq(eng, recal, job: _Job, rank, ckpt) -> int:
    """FASTQ pass 4 on the host's first rank: its files' outputs in input
    order, each window rendered and written as it is gathered.  With a
    checkpoint, ``host{h}.json`` records the files done and, in a plain
    output, the chunks and bytes of the one being written, so a rerun
    continues there (a ``.gz`` output restarts its file).  Returns the
    windows gathered."""
    from ..io.fastq import is_gz_path, open_fastq_sink, render_fastq_with_quals

    order = [fi for fi, _ in job.span]
    where = {fi: j for j, fi in enumerate(order)}
    hm = ckpt.load_host_meta(rank.host) if ckpt else {}
    files_done = int(hm.get("files_done", 0))
    done_chunks, done_bytes = int(hm.get("chunks", 0)), int(hm.get("bytes", 0))
    st = {"j": -1, "sink": None, "skip": 0, "chunk": 0, "plain": False}

    def advance(to: int) -> None:
        """Close the file being written and open the outputs up to file
        `to` (files with no window get theirs empty)."""
        while st["j"] < to:
            if st["sink"] is not None:
                st["sink"].close()
                st["sink"] = None
                if ckpt:
                    ckpt.save_host_meta(rank.host, {
                        "files_done": st["j"] + 1, "chunks": 0, "bytes": 0})
            st["j"] += 1
            j = st["j"]
            if j < files_done or j >= len(order):
                continue
            out = job.out[order[j]]
            st["plain"] = not is_gz_path(out)
            resume = (ckpt is not None and j == files_done and done_chunks
                      and st["plain"])
            if resume:
                f = open(out, "r+b")
                f.truncate(done_bytes)
                f.seek(done_bytes)
            else:
                f = open_fastq_sink(out)
            st["sink"], st["chunk"] = f, 0
            st["skip"] = done_chunks if resume else 0

    windows = 0
    try:
        for _, nq, (_, arrs, fi, fq) in eng.gathered(recal, host=True,
                                                     every=True):
            windows += 1
            j = where[fi]
            advance(j)
            chunk = st["chunk"]
            st["chunk"] += 1
            if j < files_done or chunk < st["skip"]:
                continue
            sink = st["sink"]
            sink.write(render_fastq_with_quals(fq, nq, arrs[2]))
            if ckpt and st["plain"]:
                sink.flush()
                ckpt.save_host_meta(rank.host, {
                    "files_done": j, "chunks": chunk + 1,
                    "bytes": sink.tell()})
        advance(len(order))
    finally:
        if st["sink"] is not None:
            st["sink"].close()
    return windows


def _launch(job: _Job, local: int, device_type: str, info: dict,
            timings: dict | None) -> int:
    """Run `job` on this host's `local` ranks as part of the group over
    every host -> the windows this host wrote; a host whose ranks were
    killed by ``KBBQ_CRASH_POINT`` exits with their code."""
    from torch.multiprocessing.spawn import ProcessExitedException
    run_t: dict = {}
    try:
        res = launch(_host_rank, local, device_type, job, timings=run_t,
                     hosts=Hosts(info["coordinator"], info["num_processes"],
                                 info["process_id"]))
    except ProcessExitedException as e:
        if e.exit_code == CRASH_EXIT:
            os._exit(CRASH_EXIT)
        raise
    if timings is not None:
        slowest([r[0] for r in res], timings)
        timings.update(run_t)
        timings["by_rank"] = [r[0] for r in res]
    return res[0][1]


def _setup(device, info, devices):
    """(device type, this host's info, its local ranks)."""
    from .. import resolve_device
    from .mesh import check_devices
    dev = resolve_device(device)
    info = info or init_multihost()
    local = local_devices(devices, dev.type)
    check_devices(local, dev.type)
    return dev.type, info, local


def _stats(info, local, layout, n, bases, rgs, written, windows) -> dict:
    return {"num_reads": int(n), "total_bases": int(bases),
            "read_groups": int(rgs), "host_reads_written": int(written),
            "process_id": info["process_id"],
            "num_processes": info["num_processes"],
            "devices": info["num_processes"] * local,
            "local_devices": local, "bloom_layout": layout,
            "windows": windows}


def recalibrate_fastq_multihost(in_paths, out_paths, config,
                                interleaved: bool = False,
                                chunk_reads: int | None = None,
                                info: dict | None = None,
                                checkpoint_dir: str | None = None,
                                bloom_layout: str = "auto",
                                report_out: str | None = None,
                                apply_report: str | None = None,
                                devices: int | None = None, device=None,
                                timings: dict | None = None) -> dict:
    """Streamed FASTQ recalibration over several hosts: every host calls it
    with the same arguments (`info`: ``init_multihost``'s, by default from
    the environment), runs its partition of the files on its `devices`
    local ranks (``local_devices``), and writes the output of each file it
    owns: one output per input (`out_paths`), the single host's bytes.

    checkpoint_dir (shared): pass-boundary checkpoints under the streamed
    fingerprint with ``num_processes``, ``bloom_layout``, ``chunk_reads``
    and ``interleaved`` (a rerun resumes on the same host count only), pass
    4 per host from ``host{pid}.json``.  report_out: host 0 writes the
    report; apply_report: pass 4 alone, no collective.  `timings` gets this
    host's ``scan``, the slowest local rank's stages, the launch's figures
    (``mesh.launch``) and ``by_rank``, each local rank's own stages (with
    the sharded layout's ``shard_words_a`` / ``_b``).  Returns the counts,
    this host's reads and windows, ``process_id``, ``num_processes`` and
    ``devices`` (the group's ranks).
    """
    import time

    from ..io.stream import DEFAULT_CHUNK_READS, scan_fastq_files
    from ..state.checkpoint import stream_fingerprint

    device_type, info, local = _setup(device, info, devices)
    H, pid = info["num_processes"], info["process_id"]
    if isinstance(in_paths, (str, bytes)):
        in_paths = [in_paths]
    if not isinstance(out_paths, (list, tuple)) or \
            len(out_paths) != len(in_paths):
        raise ValueError("multi-host mode needs one output path per input "
                         "file")
    chunk = int(chunk_reads or DEFAULT_CHUNK_READS)
    t0 = time.time()
    scan = scan_fastq_files(in_paths, config.k, chunk)
    t_scan = time.time() - t0
    shard = partition_inputs(in_paths, scan.per_file_reads, pid, H)
    layout = _layout(bloom_layout, config, scan.total_bases,
                     scan.total_kmers(config.k), H, local)
    fp = stream_fingerprint(config, in_paths, scan)
    fp.update(num_processes=H, bloom_layout=layout, chunk_reads=chunk,
              interleaved=bool(interleaved))
    _checkpoint(checkpoint_dir, apply_report, fp, pid)
    job = _Job("fastq", (list(in_paths), scan, bool(interleaved), chunk),
               [(rg, o) for (_, o), rg in zip(shard.paths, shard.rg_ids)],
               list(out_paths), config, layout, checkpoint_dir,
               [str(p) for p in in_paths], report_out, apply_report)
    windows = _launch(job, local, device_type, info, timings)
    if timings is not None:
        timings["scan"] = round(t_scan, 3)
    return _stats(info, local, layout, scan.num_reads, scan.total_bases,
                  len(in_paths), shard.total_reads, windows)


def _check_output(out_path: str, fmt: str) -> None:
    """The parts are `fmt` (BAM or CRAM): an output named for another
    format is refused, as on the single host's windowed routes (the
    reference writes the parts under any name)."""
    from ..pipeline.bam import _output_format
    if _output_format(out_path, fmt) != fmt:
        raise ValueError(f"the multi-host {fmt.upper()} route writes "
                         f"{fmt.upper()} parts: name the output .{fmt}")


def _part(out_path: str, pid: int, H: int) -> str:
    return f"{out_path}.part-{pid:04d}-of-{H:04d}"


def _span_fingerprint(config, use_oq: bool, n: int, bases: int, fmt: str,
                      H: int, layout: str) -> dict:
    """The JAX package's multi-host BAM / CRAM fingerprint."""
    from ..state.checkpoint import effective_ext_cap
    return {"k": config.k, "alpha": config.alpha,
            "coverage": config.coverage,
            "genome_length": config.genome_length,
            "num_hashes": config.num_hashes,
            "trust_threshold": config.trust_threshold,
            "ext_cap": effective_ext_cap(config), "use_oq": use_oq,
            "num_reads": n, "total_bases": bases, fmt: True,
            "num_processes": H, "bloom_layout": layout}


def recalibrate_bam_multihost(in_path: str, out_path: str, config,
                              use_oq: bool = False, set_oq: bool = False,
                              chunk_records: int | None = None,
                              info: dict | None = None,
                              checkpoint_dir: str | None = None,
                              bloom_layout: str = "auto",
                              report_out: str | None = None,
                              apply_report: str | None = None,
                              devices: int | None = None, device=None,
                              timings: dict | None = None) -> dict:
    """Streamed BAM recalibration over several hosts: each host takes a
    contiguous run of raw chunks of `chunk_records` records
    (``partition_bam_chunks``), reads it from its virtual offset and writes
    ``{out_path}.part-XXXX-of-YYYY`` (host 0's part with the header, the
    last host's with the EOF marker): ``cat`` of the parts is a BAM whose
    records are the single host's.  Pass 4 always runs whole.  Other
    arguments and the result (with ``part``) as
    ``recalibrate_fastq_multihost``."""
    import time

    from ..io.bam_stream import (DEFAULT_CHUNK_RECORDS, bgzf_member_index,
                                 voffset_for)
    from ..pipeline.bam import _registry_names

    _check_output(out_path, "bam")
    device_type, info, local = _setup(device, info, devices)
    H, pid = info["num_processes"], info["process_id"]
    chunk_records = int(chunk_records or DEFAULT_CHUNK_RECORDS)
    t0 = time.time()
    header_text, refs, metas, registry, n, bases, tk, max_len = \
        scan_bam_multihost(in_path, config.k, chunk_records)
    members, total_u = bgzf_member_index(in_path)
    t_scan = time.time() - t0
    lo, hi = partition_bam_chunks(metas, H)[pid]
    at = metas[lo]["stream_off"] if lo < len(metas) else total_u
    span = (*voffset_for(members, total_u, at),
            sum(m["n_records"] for m in metas[lo:hi]),
            metas[lo]["ordinal"] if lo < len(metas) else n)
    mine = sum(m["n_primary"] for m in metas[lo:hi])
    layout = _layout(bloom_layout, config, bases, tk, H, local)
    _checkpoint(checkpoint_dir, apply_report, _span_fingerprint(
        config, use_oq, n, bases, "bam", H, layout), pid)
    part = _part(out_path, pid, H)
    job = _Job("bam", (in_path, registry, max_len, mine, bases, tk,
                       bool(use_oq), chunk_records), span, part, config,
               layout, checkpoint_dir, _registry_names(registry), report_out,
               apply_report, (header_text, refs), bool(set_oq))
    windows = _launch(job, local, device_type, info, timings)
    if timings is not None:
        timings["scan"] = round(t_scan, 3)
    return {**_stats(info, local, layout, n, bases, max(1, len(registry)),
                     mine, windows), "part": part}


def recalibrate_cram_multihost(in_path: str, out_path: str, config,
                               use_oq: bool = False,
                               fasta_ref: str | None = None,
                               info: dict | None = None,
                               checkpoint_dir: str | None = None,
                               bloom_layout: str = "auto",
                               report_out: str | None = None,
                               apply_report: str | None = None,
                               devices: int | None = None, device=None,
                               timings: dict | None = None) -> dict:
    """Container-windowed CRAM recalibration over several hosts: each host
    takes a contiguous run of containers (``partition_bam_chunks`` over
    ``scan_cram_meta``'s), seeks past the others undecoded, and writes
    ``{out_path}.part-XXXX-of-YYYY`` (host 0's part with the file definition
    and header container, the last host's with the EOF container).  Where
    every container is rewritten in place (its QS blocks only), ``cat`` of
    the parts is the single host's bytes; a container the wholesale decoder
    refuses is re-encoded, its record counter counting that part's
    re-encoded records only; an output not named ``.cram`` is refused.
    Other arguments and the result as ``recalibrate_bam_multihost``."""
    import time

    from ..pipeline.bam import _registry_names
    from ..pipeline.cram_stream import scan_cram_meta

    _check_output(out_path, "cram")
    device_type, info, local = _setup(device, info, devices)
    H, pid = info["num_processes"], info["process_id"]
    t0 = time.time()
    metas, n, bases, tk, max_len, registry, rg_names, header_text = \
        scan_cram_meta(in_path, config.k, fasta_ref)
    t_scan = time.time() - t0
    lo, hi = partition_bam_chunks(metas, H)[pid]
    span = (lo, hi, metas[lo]["ordinal"] if lo < len(metas) else n)
    mine = sum(m["n_primary"] for m in metas[lo:hi])
    layout = _layout(bloom_layout, config, bases, tk, H, local)
    _checkpoint(checkpoint_dir, apply_report, _span_fingerprint(
        config, use_oq, n, bases, "cram", H, layout), pid)
    part = _part(out_path, pid, H)
    job = _Job("cram", (in_path, fasta_ref, registry, rg_names, max_len,
                        mine, bases, tk, bool(use_oq)), span, part, config,
               layout, checkpoint_dir, _registry_names(registry), report_out,
               apply_report, (header_text,))
    windows = _launch(job, local, device_type, info, timings)
    if timings is not None:
        timings["scan"] = round(t_scan, 3)
    return {**_stats(info, local, layout, n, bases, max(1, len(registry)),
                     mine, windows), "part": part}


__all__ = ["CRASH_EXIT", "HostShard", "host_steps_per_pass",
           "init_multihost", "local_devices", "partition_bam_chunks",
           "partition_inputs", "recalibrate_bam_multihost",
           "recalibrate_cram_multihost", "recalibrate_fastq_multihost",
           "scan_bam_multihost"]

"""Container-windowed CRAM recalibration on one device.

Counterpart of ``kbbq_tpu/pipeline/cram_stream.py``: the same scan, the same
decode (wholesale per slice, ``io/cram_vec.py``, with the per-record
decoder for containers it refuses) and the same output bytes, on the port's
windowed engine (``pipeline/stream_resident.py::StreamResidentEngine``):

- a window is one CRAM container that holds a primary record, at the global
  ordinal of its first primary record (sampling keys on global ordinals, so
  the bytes do not depend on how the file is cut into containers);
  containers without one ride with the window before them (or with the
  first window), so pass 4 writes every container in order;
- containers are read and decoded on a prefetch thread and kept on the host
  under ``host_cache_bytes``;
- pass 4 is the device gather per window, then per slice the QS stream
  rebuilt from the window's new qualities (reverse-strand reads flipped
  back to stored orientation, the original bytes kept for non-primary
  records and where CF&1 is unset) and ``rewrite_container_quals``, which
  swaps only the QS blocks; a container the wholesale decoder refused is
  re-encoded (``write_cram``'s profile) from its records.  Writes run in
  order on one thread.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import resolve_device
from ..io.bam import machine_order_read, rewrite_quals
from ..io.cram import (CT_EXTERNAL, CramStream, decode_slice,
                       parse_compression_header, parse_slice_header,
                       split_slices)
from ..io.cram_vec import _ragged_flat_index, decode_slice_vec, scan_slice_vec
from ..io.cram_write import CramStreamWriter, rewrite_container_quals
from ..io.fasta import read_fasta
from ..io.stream import prefetch_iter
from .resident import StageClock
from .stream_resident import (DEFAULT_HOST_CACHE_BYTES, StreamResidentEngine,
                              _HostChunkCache)


def _rg_key(rg_names: list, rg: int) -> str:
    return rg_names[rg] if 0 <= rg < len(rg_names) else ""


def _decode_container(comp, blocks, cont, refs, ref_names, max_len, rg_lut,
                      use_oq):
    """Per-slice decode of one container: a list of ("fast", (codes, quals,
    mask, rgs, seconds, lens, prim, n), squals) per slice, or, when any
    slice needs the per-record decoder, ("slow", records, None) for every
    slice (pass 4 re-encodes whole containers)."""
    out = []
    groups = split_slices(blocks)
    for group in groups:
        fast = decode_slice_vec(comp, group, refs, ref_names, max_len,
                                rg_lut, use_oq)
        if fast is None:
            break
        codes, quals, mask, rgs, seconds, lens, prim, squals = fast
        n = parse_slice_header(group[0].data).n_records
        out.append(("fast", (codes, quals, mask, rgs, seconds, lens, prim,
                             n), squals))
    if len(out) == len(groups):
        return out
    return [("slow", decode_slice(comp, group, cont.ref_id, refs, ref_names),
             None) for group in groups]


def _slow_arrays(recs, max_len, registry, rg_names, use_oq):
    """(codes, quals, mask, rgs, seconds, lens, prim) of a record list: the
    per-record counterpart of decode_slice_vec's output."""
    prim = [i for i, r in enumerate(recs)
            if not r.is_secondary_or_supp and r.l_seq > 0]
    n = len(prim)
    codes = np.full((n, max_len), 4, np.int8)
    quals = np.zeros((n, max_len), np.int8)
    mask = np.zeros((n, max_len), bool)
    rgs = np.zeros(n, np.int32)
    seconds = np.zeros(n, bool)
    lens = np.zeros(n, np.int64)
    for j, i in enumerate(prim):
        rec = recs[i]
        c, q = machine_order_read(rec, use_oq=use_oq)
        L = c.size
        codes[j, :L] = c
        quals[j, :L] = np.clip(q, 0, 93)
        mask[j, :L] = True
        lens[j] = L
        seconds[j] = rec.is_read2
        rgs[j] = registry.get(_rg_key(rg_names, getattr(rec, "_cram_rg", -1)),
                              0)
    return codes, quals, mask, rgs, seconds, lens, np.asarray(prim, np.int64)


def scan_cram_meta(path: str, k: int, fasta_ref: str | None):
    """Per-container metadata pass: (metas, num_primary, total_bases,
    total_kmers, max_len, registry, rg_names, header_text).  metas[i] =
    {"n_records", "n_primary", "ordinal", "slice_prims"} for data container
    i (ordinal: the global primary ordinal of its first primary record;
    the unit a multi-host run partitions on, ROADMAP A16).  registry is
    RG name -> dense id in first-appearance order over primary records, as
    the whole-file route's."""
    refs = read_fasta(fasta_ref) if fasta_ref else None
    n = bases = tk = 0
    max_len = 1
    registry: dict[str, int] = {}
    metas: list[dict] = []
    with CramStream(path) as cs:
        rg_names = cs.rg_names
        for cont, blocks, _ in cs.containers():
            comp = parse_compression_header(blocks[0].data)
            c_prim = c_rec = 0
            ordinal0 = n
            slice_prims: list[int] = []
            for group in split_slices(blocks):
                light = scan_slice_vec(comp, group)
                if light is not None:
                    bf, rl, rg = light
                    pm = ((bf & 0x900) == 0) & (rl > 0)
                    pl = rl[pm]
                    prg = rg[pm]
                    c_rec += bf.size
                else:
                    recs = decode_slice(comp, group, cont.ref_id, refs,
                                        cs.ref_names)
                    pm_list = [r for r in recs
                               if not r.is_secondary_or_supp and r.l_seq > 0]
                    pl = np.asarray([r.l_seq for r in pm_list], np.int64)
                    prg = np.asarray(
                        [getattr(r, "_cram_rg", -1) for r in pm_list],
                        np.int64)
                    c_rec += len(recs)
                n += pl.size
                c_prim += pl.size
                slice_prims.append(int(pl.size))
                bases += int(pl.sum())
                tk += int(np.maximum(pl - k + 1, 0).sum())
                if pl.size:
                    max_len = max(max_len, int(pl.max()))
                    _, first = np.unique(prg, return_index=True)
                    for rgv in prg[np.sort(first)]:
                        key = _rg_key(rg_names, int(rgv))
                        if key not in registry:
                            registry[key] = len(registry)
            metas.append({"n_records": c_rec, "n_primary": c_prim,
                          "ordinal": ordinal0, "slice_prims": slice_prims})
        if not registry:
            registry[""] = 0
        return (metas, n, bases, tk, max_len, registry, rg_names,
                cs.header_text)


def scan_cram(path: str, k: int, fasta_ref: str | None):
    """(num_primary, total_bases, total_kmers, max_len, registry, rg_names,
    header_text): scan_cram_meta less the per-container rows."""
    return scan_cram_meta(path, k, fasta_ref)[1:]


class CramWindowSource:
    """Windows over a CRAM: one window per container that holds a primary
    record, at the global ordinal of its first primary record.  Items:
    (ordinal, arrays, conts): arrays the (codes, quals, mask, rgs, seconds)
    of the container's primary records, slice after slice; conts the
    (cont, blocks, raw, slices, rows) of that container and of the
    containers without a primary record around it (those before the first
    window go with it, the others with the window before them); rows[j] is
    the number of primary records of slice j.  `span`: (first container,
    end container, global ordinal of the first primary) of a run of data
    containers to cover instead of the file, those before it seeked over
    undecoded (a host's range on several hosts,
    ``parallel/multihost.py``); `num_reads` is then the span's
    primaries."""

    def __init__(self, path: str, fasta_ref: str | None, registry: dict,
                 rg_names: list, max_len: int, num_reads: int,
                 total_bases: int, total_kmers_: int, use_oq: bool,
                 host_cache_bytes: int = DEFAULT_HOST_CACHE_BYTES,
                 span=None):
        self.path = path
        self.span = span
        self.registry = registry
        self.rg_names = rg_names
        self.num_rg = max(1, len(registry))
        self.max_len = max_len
        self.num_reads = num_reads
        self.total_bases = total_bases
        self._tk = total_kmers_
        self.use_oq = use_oq
        self._cache = _HostChunkCache(host_cache_bytes)
        self.refs = read_fasta(fasta_ref) if fasta_ref else None
        # CRAM numeric RG (+1, so -1 -> slot 0) -> dense registry id
        lut = np.zeros(len(rg_names) + 1, np.int32)
        lut[0] = registry.get("", 0)
        for i, nm in enumerate(rg_names):
            lut[i + 1] = registry.get(nm, 0)
        self.rg_lut = lut

    def total_kmers(self, k: int) -> int:
        return self._tk

    def _arrays(self, slices):
        """(arrays, rows) of a container's primary records, slice after
        slice."""
        parts = []
        for kind, payload, _ in slices:
            if kind == "fast":
                parts.append(payload[:5])
            else:
                parts.append(_slow_arrays(payload, self.max_len,
                                          self.registry, self.rg_names,
                                          self.use_oq)[:5])
        rows = [int(p[0].shape[0]) for p in parts]
        if len(parts) == 1:
            return parts[0], rows
        return tuple(np.concatenate(a) for a in zip(*parts)), rows

    def _read(self):
        """(cont, blocks, raw, slices, arrays, rows) per container, read and
        decoded in order."""
        lo, hi = (0, None) if self.span is None else self.span[:2]
        if hi is not None and lo >= hi:
            return
        with CramStream(self.path) as cs:
            ref_names = cs.ref_names
            for i, (cont, blocks, raw) in enumerate(cs.containers(skip=lo),
                                                    lo):
                if hi is not None and i >= hi:
                    break
                comp = parse_compression_header(blocks[0].data)
                slices = _decode_container(comp, blocks, cont, self.refs,
                                           ref_names, self.max_len,
                                           self.rg_lut, self.use_oq)
                arrays, rows = self._arrays(slices)
                yield cont, blocks, raw, slices, arrays, rows

    def containers_decoded(self):
        """(cont, blocks, raw, slices, arrays, rows) per container, decoded
        on a prefetch thread and memoised under the host cache budget."""
        if self._cache.complete:
            yield from self._cache.items
            return
        self._cache.restart()
        for item in prefetch_iter(self._read(), depth=2):
            self._cache.add(item, len(item[2])
                            + sum(a.nbytes for a in item[4]))
            yield item
        self._cache.finish()

    def windows(self):
        pending: list = []    # containers with no primary record, not yet placed
        held = None           # the last window, waiting for what follows it
        ordinal = 0 if self.span is None else int(self.span[2])
        for cont, blocks, raw, slices, arrays, rows in \
                self.containers_decoded():
            item = (cont, blocks, raw, slices, rows)
            n = sum(rows)
            if not n:
                (held[2] if held is not None else pending).append(item)
                continue
            if held is not None:
                yield held
            held = (ordinal, arrays, pending + [item])
            pending = []
            ordinal += n
        if held is not None:
            yield held


def container_new_qs(slices, blocks, nq, rows, max_len: int):
    """Recalibrated QS streams of a container whose slices all decoded
    wholesale: per slice, (qs_cid, new QS bytes) or None, the input of
    rewrite_container_quals.  nq: new qualities (int8, machine order) of
    the container's primary records, slice after slice (None when it has
    none).  Original QS bytes are kept wherever a record's span is not
    rewritten (non-primary, CF&1 unset)."""
    # every slice carries its OWN QS block under the SAME content id, so the
    # lookup stays within the slice's block group: a container-wide search
    # would hand slice 2 the first slice's bytes
    groups = split_slices(blocks)
    qs_new = []
    start = 0
    for (_, payload, squals), group, r in zip(slices, groups, rows):
        lens, prim = payload[5], payload[6]
        q = None if nq is None else nq[start:start + r]
        start += r
        if prim.size == 0 or squals.qs_len == 0 or not squals.lens.any():
            qs_new.append(None)
            continue
        qs_block = next(b for b in group
                        if b.content_id == squals.qs_cid
                        and b.content_type == CT_EXTERNAL)
        qs_arr = np.frombuffer(qs_block.data, np.uint8).copy()
        wl = squals.lens          # 0 where CF&1 is unset
        vals = np.zeros((prim.size, max_len), np.uint8)
        fwd = q.astype(np.uint8)
        for Lg in np.unique(lens):
            sel = np.flatnonzero(lens == Lg)
            Lg = int(Lg)
            v = fwd[sel, :Lg].copy()
            rv = squals.rev[sel]
            v[rv] = v[rv, ::-1]
            vals[sel, :Lg] = v
        flat_src = _ragged_flat_index(np.arange(prim.size, dtype=np.int64),
                                      np.zeros(prim.size, np.int64), wl,
                                      max_len)
        flat_dst = _ragged_flat_index(np.zeros(prim.size, np.int64),
                                      squals.offs, wl, 0)
        qs_arr[flat_dst] = vals.reshape(-1)[flat_src]
        qs_new.append((squals.qs_cid, qs_arr.tobytes()))
    return qs_new


def rewrite_fallback_container(slices, nq, max_len: int, registry, rg_names,
                               use_oq: bool):
    """A container decoded record by record: its primary records' qualities
    replaced by nq (int8, machine order, the container's primaries in
    order; None when it has none), every record's numeric RG kept; returns
    the records for re-encoding."""
    recs_all = []
    for kind, payload, _ in slices:
        if kind != "slow":
            raise RuntimeError("mixed fast/slow slices in one container are "
                               "re-encoded whole")
        recs_all.extend(payload)
    lens, prim = _slow_arrays(recs_all, max_len, registry, rg_names,
                              use_oq)[5:]
    for j, i in enumerate(prim):
        rewrite_quals(recs_all[int(i)], nq[j][:int(lens[j])], set_oq=False)
    for rec in recs_all:
        if not hasattr(rec, "_rg_index"):
            rec._rg_index = getattr(rec, "_cram_rg", -1)
    return recs_all


def recalibrate_cram_stream_resident(
        in_path: str, out_path, config, use_oq: bool = False,
        set_oq: bool = False, fasta_ref: str | None = None,
        checkpoint_dir: str | None = None, timings: dict | None = None,
        report_out: str | None = None, apply_report: str | None = None,
        device=None, host_cache_bytes: int = DEFAULT_HOST_CACHE_BYTES,
        device_cache_bytes: int | None = None) -> dict:
    """CRAM -> CRAM recalibration through the windowed engine, one window
    per container; host memory O(container) when the host cache is off or
    overflows.  The output bytes equal the JAX package's
    ``recalibrate_cram_stream_resident``'s for any of its window sizes: the
    QS blocks of each container rewritten in place, every other block's
    bytes kept, containers the wholesale decoder refuses re-encoded.

    set_oq raises (an OQ tag per record changes the tag streams: the
    whole-file route, ``pipeline/bam.py::recalibrate_cram``, writes it).
    fasta_ref: the FASTA a reference-based CRAM was encoded against.
    checkpoint_dir: pass-boundary checkpoints under the JAX package's CRAM
    fingerprint (pass 4 always runs whole).  report_out / apply_report,
    use_oq, host_cache_bytes / device_cache_bytes, timings (seconds and,
    on a card, peak device bytes of scan, setup, pass1-4, deltas) and
    device as in ``recalibrate_bam_streaming``.
    """
    from .bam import _registry_names

    if set_oq:
        raise ValueError(
            "--set-oq with streaming CRAM is unsupported; the "
            "whole-file CRAM path handles it")
    dev = resolve_device(device)
    clock = StageClock(timings, dev)
    n, bases, tk, max_len, registry, rg_names, header_text = scan_cram(
        in_path, config.k, fasta_ref)
    clock.mark("scan")
    src = CramWindowSource(in_path, fasta_ref, registry, rg_names, max_len,
                           n, bases, tk, use_oq, host_cache_bytes)
    eng = StreamResidentEngine(src, config, dev, device_cache_bytes)
    ckpt = None
    if checkpoint_dir:
        # the JAX package's CRAM fingerprint: each package resumes the other's
        from ..state.checkpoint import Checkpoint, effective_ext_cap
        ckpt = Checkpoint(checkpoint_dir)
        ckpt.check_fingerprint({
            "k": config.k, "alpha": config.alpha,
            "coverage": config.coverage,
            "genome_length": config.genome_length,
            "num_hashes": config.num_hashes,
            "trust_threshold": config.trust_threshold,
            "ext_cap": effective_ext_cap(config), "use_oq": use_oq,
            "num_reads": n, "total_bases": bases, "cram": True})
    names = _registry_names(registry)
    clock.mark("setup")

    if apply_report is not None:
        from ..gatk_report import read_gatk_report, recal_table_from_report
        recal = recal_table_from_report(read_gatk_report(apply_report),
                                        names, eng.L)
    else:
        recal = eng.run_passes_1_to_3(ckpt, clock.mark)
        if report_out is not None:
            from ..gatk_report import write_gatk_report
            write_gatk_report(eng.tables, names, report_out)

    # ---- pass 4: gather on the card, rebuild + write in order on one thread
    windows = write_cram_windows(eng, recal, src,
                                 CramStreamWriter(out_path, header_text))
    clock.mark("pass4")
    return {"num_reads": n, "total_bases": bases, "read_groups": eng.num_rg,
            "streamed": True, "engine": "resident-window", "format": "cram",
            "windows": windows}


def write_cram_windows(eng, recal, src, writer) -> int:
    """Pass 4 of the container-windowed route into `writer` (closed at the
    end): each window's gather on the card, then per container the QS
    blocks rebuilt (a container the wholesale decoder refused re-encoded)
    and written in order on one thread; a source with no window writes
    every container as it is.  Returns the windows."""
    wex = ThreadPoolExecutor(1)
    pending: list = []

    def put(cont, blocks, raw, slices, rows, nq):
        if all(kind == "fast" for kind, _, _ in slices):
            writer.write_raw(rewrite_container_quals(
                cont, blocks, raw,
                container_new_qs(slices, blocks, nq, rows, src.max_len)))
        else:
            writer.write_records(rewrite_fallback_container(
                slices, nq, src.max_len, src.registry, src.rg_names,
                src.use_oq))

    windows = 0
    try:
        for _, nq, (_, _, conts) in eng.gathered(recal, host=True,
                                                 every=True):
            windows += 1
            if len(pending) >= 2:     # at most two windows wait to be written
                pending.pop(0).result()
            for cont, blocks, raw, slices, rows in conts:
                pending.append(wex.submit(put, cont, blocks, raw, slices,
                                          rows, nq if sum(rows) else None))
        if not windows:                  # no primary record in the source
            for cont, blocks, raw, slices, _, rows in \
                    src.containers_decoded():
                pending.append(wex.submit(put, cont, blocks, raw, slices,
                                          rows, None))
    finally:
        try:
            for f in pending:     # every queued write, before the sink closes
                f.result()
        finally:
            wex.shutdown(wait=True)
            writer.close()
    return windows

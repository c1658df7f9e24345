"""BAM, SAM and CRAM recalibration (BASELINE config 3).

Counterpart of ``kbbq_tpu/pipeline/bam.py``: the same four passes as FASTQ,
with the differences handled at the IO boundary: machine-order
re-orientation, RG-tag read groups, --use-oq / --set-oq, secondary and
supplementary records passed through untouched.  Two routes:

- ``recalibrate_bam``: the whole file in host memory.  A BAM goes through
  the native record index, ``decode_machine_chunk`` over the whole
  alignment section, ``_run_or_apply`` (the resident path, or the windowed
  engine when the data does not fit the card), ``rewrite_quals_chunk`` over
  the whole section and one BGZF compress: no per-record object on the
  way.  SAM input, and SAM output from BAM input, go through the record
  model (``io/sam.py``), as in the JAX package.
- ``recalibrate_bam_streaming``: raw chunks through the windowed engine,
  host memory O(chunk) (``pipeline/stream_resident.py::
  recalibrate_bam_stream_resident``).
- ``recalibrate_cram``: a CRAM in host memory.  Its records are decoded by
  the per-record CRAM decoder (``io/cram.py``) and laid back to back in one
  buffer of BAM record bodies; from there on it is ``recalibrate_bam``'s
  route: ``decode_machine_chunk``, ``_run_or_apply``,
  ``rewrite_quals_chunk``.  The container-windowed CRAM route is
  ``pipeline/cram_stream.py``.

All write the JAX package's bytes.  The output format follows the output's
extension (``.sam``, ``.bam`` or ``.cram``, the last through
``io/cram_write.py::write_cram``; an unnamed sink keeps the input's, BAM for
a CRAM input).  With ``devices`` > 1 the recalibration runs on that many
ranks (``parallel/``); the host stages of the whole-file routes stay in the
caller's process.
"""

from __future__ import annotations

import struct
import time

import numpy as np

from .. import resolve_device
from ..io import bgzf
from ..io.bam import (BamFile, bam_header_bytes, index_bam_bytes,
                      machine_order_read, read_bam_bytes, record_from_body,
                      rewrite_quals, serialize_bam)
from ..io.batcher import ReadArrays
from ..io.native_lib import bam_offsets
from .recalibrate import RecalConfig, _run_or_apply


def scan_bam(path: str, k: int, chunk_records: int | None = None):
    """Streaming metadata pass: (num_primary, total_bases, total_kmers,
    max_len, registry) — registry is RG-tag -> dense id in
    first-appearance order over primary records.  Whole-chunk vectorised
    (io/bam_vec.py::scan_chunk); no per-record objects."""
    from ..io.bam_stream import DEFAULT_CHUNK_RECORDS, iter_bam_raw_chunks
    from ..io.bam_vec import scan_chunk
    _, _, chunks = iter_bam_raw_chunks(
        path, chunk_records or DEFAULT_CHUNK_RECORDS)
    n = bases = tk = 0
    max_len = 1
    registry: dict[str, int] = {}
    for buf, offs, sizes in chunks:
        cn, cb, ck, cl, keys = scan_chunk(buf, offs, sizes, k)
        n += cn
        bases += cb
        tk += ck
        max_len = max(max_len, cl)
        for key in keys:
            if key not in registry:
                registry[key] = len(registry)
    return n, bases, tk, max_len, registry


def bam_read_group_ids(bf, records):
    """Dense RG index per record (registry order = first appearance);
    records without an RG tag share the key ""."""
    registry: dict[str, int] = {}
    rgs = np.zeros(len(records), dtype=np.int32)
    for i, rec in enumerate(records):
        tag = rec.get_zstr("RG")
        key = tag.decode() if tag is not None else ""
        if key not in registry:
            registry[key] = len(registry)
        rgs[i] = registry[key]
    return rgs, registry


def _registry_names(registry: dict) -> list:
    """Registry (RG tag -> dense id) back to names in dense-id order —
    the ReadGroup labels GATK-report interop keys on (P9)."""
    return [k for k, _ in sorted(registry.items(), key=lambda kv: kv[1])]


def _output_format(out_path, default_fmt: str) -> str:
    """"sam", "cram" or "bam" by the OUTPUT's extension; an unnamed sink (a
    file object) keeps `default_fmt`, the input's format."""
    name = out_path if isinstance(out_path, (str, bytes)) else None
    sfx = (name.decode() if isinstance(name, bytes) else name) or ""
    if sfx.endswith(".sam"):
        return "sam"
    if sfx.endswith(".cram"):
        return "cram"
    if sfx.endswith(".bam"):
        return "bam"
    return default_fmt


def _write_bytes(data, out_path) -> None:
    if isinstance(out_path, (str, bytes)):
        with open(out_path, "wb") as f:
            f.write(data)
    else:
        out_path.write(data)


def _assign_cram_rg(bf, primary, rgs, registry) -> None:
    """Numeric RG per record for the CRAM writer.

    The CRAM wire format's RG integer indexes the HEADER's @RG line order,
    which need not match the registry's record-first-appearance order (a
    file whose first record carries the header's second RG would swap
    groups on write).  So each record's RG NAME (the registry's name of its
    dense id for primaries, its RG:Z tag otherwise) maps to its header
    index."""
    hdr_idx: dict[str, int] = {}
    for ln in bf.header_text.splitlines():
        if ln.startswith("@RG"):
            for fld in ln.split("\t")[1:]:
                if fld.startswith("ID:"):
                    hdr_idx.setdefault(fld[3:], len(hdr_idx))
    name_of = {v: k for k, v in registry.items()}
    for i, rec in enumerate(primary):
        rec._rg_index = hdr_idx.get(name_of.get(int(rgs[i]), ""), -1)
    for rec in bf.records:
        if hasattr(rec, "_rg_index"):
            continue
        tag = rec.get_zstr("RG")
        key = tag.decode() if tag is not None else ""
        rec._rg_index = hdr_idx.get(key, -1)


def _write_alignment_output(bf, out_path, fmt: str, primary=None, rgs=None,
                            registry=None) -> None:
    """Serialize the record model as `fmt` ("sam", "bam" or "cram"; CRAM
    needs the primary records with their dense read-group ids and the
    registry)."""
    if fmt == "cram":
        from ..io.cram_write import write_cram
        _assign_cram_rg(bf, primary, rgs, registry)
        write_cram(bf, out_path)
    elif fmt == "sam":
        from ..io.sam import serialize_sam
        _write_bytes(serialize_sam(bf), out_path)
    else:
        _write_bytes(serialize_bam(bf, compress=True), out_path)


def _records_buffer(records):
    """(buf, offs, sizes): the records' bodies back to back, each after its
    block_size, as a uint8 array, with the int64 body offsets and sizes
    (the native record index of the buffer)."""
    buf = np.frombuffer(b"".join(
        [struct.pack("<i", len(r.data)) + bytes(r.data) for r in records]),
        np.uint8)
    offs, sizes, _ = bam_offsets(buf)
    return buf, offs, sizes


def _records_of(buf) -> list:
    """BamRecords of a buffer of back-to-back raw records."""
    arr = np.frombuffer(buf, np.uint8)
    offs, sizes, _ = bam_offsets(arr)
    return [record_from_body(bytearray(arr[o:o + s].tobytes()))
            for o, s in zip(offs.tolist(), sizes.tolist())]


def _read_sam_arrays(in_path: str, use_oq: bool):
    """(BamFile, primary records, ReadArrays, lens, registry) of a SAM
    input, through the record model."""
    from ..io.sam import read_sam
    bf = read_sam(in_path)
    primary = [r for r in bf.records
               if not r.is_secondary_or_supp and r.l_seq > 0]
    codes_list, quals_list, seconds = [], [], []
    for rec in primary:
        c, q = machine_order_read(rec, use_oq=use_oq)
        codes_list.append(c)
        quals_list.append(np.clip(q, 0, 93).astype(np.int8))
        seconds.append(rec.is_read2)
    rgs, registry = bam_read_group_ids(bf, primary)
    lens = np.asarray([len(c) for c in codes_list], np.int64)
    arrays = ReadArrays.from_lists(codes_list, quals_list, rgs, seconds,
                                   max_len=int(lens.max(initial=1)))
    return bf, primary, arrays, lens, registry


def recalibrate_bam(in_path: str, out_path, config: RecalConfig,
                    use_oq: bool = False, set_oq: bool = False,
                    checkpoint_dir: str | None = None,
                    report_out: str | None = None,
                    apply_report: str | None = None, device=None,
                    timings: dict | None = None,
                    devices: int | None = None,
                    bloom_layout: str = "auto") -> dict:
    """BAM or SAM (``.sam``, ``.sam.gz``) -> BAM or SAM recalibration with
    the whole file in host memory.

    The input may be BGZF, plain gzip or raw BAM.  The output format
    follows out_path's extension (an unnamed sink keeps the input's), a
    ``.cram`` output through ``write_cram``.  use_oq: recalibrate from
    the OQ tags' qualities; set_oq: keep each primary record's original
    qualities in an OQ tag.  checkpoint_dir, report_out and apply_report
    as in ``recalibrate_fastq`` (read groups are the RG tags, in order of
    first appearance over primary records).  device=None means the CUDA
    device (raises without one).  `timings` gets the pipeline's stages and
    the host's: ``read`` (file read and inflate), ``decode`` (index, scan
    and decode), ``rewrite`` and ``write`` (compress and write).  devices,
    bloom_layout: as in ``run_pipeline`` (the host stages stay in this
    process).
    """
    dev = resolve_device(device)
    is_sam = str(in_path).endswith((".sam", ".sam.gz"))
    fmt = _output_format(out_path, "sam" if is_sam else "bam")
    mark = _stage_marker(timings)
    run_kw = dict(device=dev, timings=timings, checkpoint_dir=checkpoint_dir,
                  devices=devices, bloom_layout=bloom_layout)
    if is_sam:
        bf, primary, arrays, lens, registry = _read_sam_arrays(in_path,
                                                               use_oq)
        mark("read")
        new_quals = _run_or_apply(arrays, config, _registry_names(registry),
                                  report_out, apply_report, **run_kw)
        mark(None)
        for i, rec in enumerate(primary):
            rewrite_quals(rec, new_quals[i][:int(lens[i])], set_oq=set_oq)
        mark("rewrite")
        _write_alignment_output(bf, out_path, fmt, primary, arrays.rgs,
                                registry)
        mark("write")
        return {"num_reads": len(primary), "total_bases": int(lens.sum()),
                "read_groups": len(registry)}

    raw = read_bam_bytes(in_path)
    mark("read")
    return _recalibrate_records(*index_bam_bytes(raw), out_path, fmt, config,
                                use_oq, set_oq, report_out, apply_report,
                                run_kw, mark)


def _stage_marker(timings: dict | None):
    """mark(name): the seconds since the last mark into timings[name] (when
    timings is given); mark(None) restarts the clock only."""
    stamps = [time.time()]

    def mark(name):
        now = time.time()
        if timings is not None and name is not None:
            timings[name] = round(now - stamps[0], 3)
        stamps[0] = now
    return mark


def _recalibrate_records(header_text, refs, buf, offs, sizes, out_path,
                         fmt: str, config, use_oq: bool, set_oq: bool,
                         report_out, apply_report, run_kw: dict, mark,
                         cram: bool = False) -> dict:
    """The whole-file route from a buffer of back-to-back BAM records (each
    after its block_size; offs / sizes their bodies): scan, whole-buffer
    decode (``decode`` stage), ``_run_or_apply``, QUAL rewrite
    (``rewrite``) and the output as `fmt` (``write``).  `cram`: the
    records came from a CRAM, whose qualities the JAX package reads as
    int8 (``_wrapped_quals_to_zero``)."""
    from ..io.bam_vec import (decode_machine_chunk, rewrite_quals_chunk,
                              scan_chunk)
    _, _, _, max_len, keys = scan_chunk(buf, offs, sizes, config.k)
    registry = {key: i for i, key in enumerate(keys)}
    codes, quals, mask, rgs, seconds, lens, prim = decode_machine_chunk(
        buf, offs, sizes, max_len, registry, use_oq=use_oq)
    if cram:
        _wrapped_quals_to_zero(buf, offs, sizes, prim, lens, quals, use_oq)
    arrays = ReadArrays(codes, quals, mask, rgs, seconds)
    mark("decode")
    new_quals = _run_or_apply(arrays, config, _registry_names(registry),
                              report_out, apply_report, **run_kw)
    del arrays, codes, quals, mask
    mark(None)
    records = rewrite_quals_chunk(buf, offs, sizes, prim, lens, new_quals,
                                  set_oq=set_oq)
    del new_quals
    mark("rewrite")
    _write_records(header_text, refs, records, prim, rgs, registry, out_path,
                   fmt)
    mark("write")
    return {"num_reads": int(prim.size), "total_bases": int(lens.sum()),
            "read_groups": len(registry)}


def _write_records(header_text, refs, records, prim, rgs, registry, out_path,
                   fmt: str) -> None:
    """Write a buffer of back-to-back records (block_size prefixes
    included) as `fmt`: BAM as one BGZF stream of header and records; SAM
    and CRAM through the record model (prim: the primary records' indices,
    rgs their dense read-group ids, for the CRAM writer)."""
    if fmt == "bam":
        head = np.frombuffer(bam_header_bytes(header_text, refs), np.uint8)
        _write_bytes(bgzf.compress(np.concatenate(
            [head, np.frombuffer(records, np.uint8)])), out_path)
        return
    recs = _records_of(records)
    _write_alignment_output(BamFile(header_text, refs, recs), out_path, fmt,
                            [recs[i] for i in prim.tolist()], rgs, registry)


def recalibrate_bam_streaming(in_path: str, out_path, config: RecalConfig,
                              use_oq: bool = False, set_oq: bool = False,
                              checkpoint_dir: str | None = None,
                              devices: int | None = None,
                              chunk_records: int | None = None,
                              report_out: str | None = None,
                              apply_report: str | None = None, device=None,
                              timings: dict | None = None,
                              host_cache_bytes: int | None = None,
                              device_cache_bytes: int | None = None,
                              bloom_layout: str = "auto") -> dict:
    """BAM -> BAM recalibration with O(chunk) host memory, through the
    windowed engine; the same bytes as ``recalibrate_bam`` for any
    `chunk_records`.  The output is BAM: a ``.sam`` or ``.cram`` name
    raises.  devices > 1 runs the engine on that many ranks
    (``parallel/sharded.py::recalibrate_bam_sharded``, refusals as in
    ``run_pipeline``), the same bytes.  Arguments as ``recalibrate_bam``
    and ``stream_resident.recalibrate_bam_stream_resident``."""
    if _output_format(out_path, "bam") != "bam":
        raise ValueError("the streamed route writes BAM; recalibrate_bam "
                         "writes SAM")
    if devices is not None and devices > 1:
        from ..parallel.sharded import recalibrate_bam_sharded
        return recalibrate_bam_sharded(
            in_path, out_path, config, devices, use_oq=use_oq,
            set_oq=set_oq, checkpoint_dir=checkpoint_dir,
            chunk_records=chunk_records, timings=timings,
            report_out=report_out, apply_report=apply_report, device=device,
            host_cache_bytes=host_cache_bytes,
            device_cache_bytes=device_cache_bytes,
            bloom_layout=bloom_layout)
    from .stream_resident import (DEFAULT_HOST_CACHE_BYTES,
                                  recalibrate_bam_stream_resident)
    return recalibrate_bam_stream_resident(
        in_path, out_path, config, use_oq=use_oq, set_oq=set_oq,
        checkpoint_dir=checkpoint_dir, chunk_records=chunk_records,
        timings=timings, report_out=report_out, apply_report=apply_report,
        device=device,
        host_cache_bytes=(DEFAULT_HOST_CACHE_BYTES if host_cache_bytes is None
                          else host_cache_bytes),
        device_cache_bytes=device_cache_bytes)


def _wrapped_quals_to_zero(buf, offs, sizes, prim, lens, quals,
                           use_oq: bool) -> None:
    """The JAX package reads a CRAM record's qualities as int8 (on the
    whole-file route through ``machine_order_read``, on the streamed one
    through ``io/cram_vec.py``): a QUAL byte >= 128, or an OQ byte >= 161,
    wraps negative and clips to 0, where ``decode_machine_chunk`` clips it
    to 93.  Sets those of `quals` (machine order, int8 [n_prim, L]) to 0, in
    place."""
    from ..io.bam_vec import aux_scan, bam_fields
    if not prim.size:
        return
    f = bam_fields(buf, offs)
    if use_oq:
        found, _ = aux_scan(buf, f["aux_off"][prim], offs[prim] + sizes[prim],
                            ("OQ",))
        src, limit = found["OQ"][0], 161
    else:
        src, limit = f["qual_off"][prim], 128
    rev = (f["flag"][prim] & 0x10) != 0
    L = quals.shape[1]
    col = np.arange(L, dtype=np.int64)
    for s in range(0, prim.size, 65536):
        rows = np.arange(s, min(prim.size, s + 65536))
        rows = rows[src[rows] >= 0]          # the aux walk's refusals: exact
        ln = lens[rows][:, None]
        stored = np.where(rev[rows][:, None], ln - 1 - col, col)
        inside = col < ln
        at = src[rows][:, None] + np.where(inside, stored, 0)
        hi = inside & (buf[np.minimum(at, buf.size - 1)] >= limit)
        if hi.any():
            q = quals[rows]
            q[hi] = 0
            quals[rows] = q


def recalibrate_cram(in_path: str, out_path, config: RecalConfig,
                     use_oq: bool = False, set_oq: bool = False,
                     fasta_ref: str | None = None,
                     checkpoint_dir: str | None = None,
                     devices: int | None = None,
                     report_out: str | None = None,
                     apply_report: str | None = None, device=None,
                     timings: dict | None = None,
                     bloom_layout: str = "auto") -> dict:
    """CRAM -> BAM, SAM or CRAM recalibration with the whole file in host
    memory; the JAX package's ``recalibrate_cram`` bytes.

    The records are decoded by ``io/cram.py::read_cram`` (reference-based
    files against `fasta_ref`, or an embedded reference), laid back to back
    as BAM record bodies with their RG tags, and from there take
    ``recalibrate_bam``'s route.  The output format follows out_path's
    extension (an unnamed sink gets BAM).  use_oq, set_oq, checkpoint_dir,
    report_out, apply_report, device, `timings` (``read`` is the CRAM
    decode), devices and bloom_layout as in ``recalibrate_bam``.
    """
    from ..io.cram import read_cram

    dev = resolve_device(device)
    fmt = _output_format(out_path, "bam")
    mark = _stage_marker(timings)
    bf, _ = read_cram(in_path, fasta_ref=fasta_ref)
    buf, offs, sizes = _records_buffer(bf.records)
    header_text, refs = bf.header_text, bf.refs
    del bf
    mark("read")
    return _recalibrate_records(
        header_text, refs, buf, offs, sizes, out_path, fmt, config, use_oq,
        set_oq, report_out, apply_report,
        dict(device=dev, timings=timings, checkpoint_dir=checkpoint_dir,
             devices=devices, bloom_layout=bloom_layout),
        mark, cram=True)

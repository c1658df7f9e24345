"""BAM and SAM recalibration on one device (BASELINE config 3).

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

Both write the JAX package's bytes.  The output format follows the output's
extension (``.sam`` or ``.bam``; an unnamed sink keeps the input's); CRAM
comes with ROADMAP A13, the multi-device streamed route with A15.
"""

from __future__ import annotations

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
    """"sam" or "bam" by the OUTPUT's extension; an unnamed sink (a file
    object) keeps `default_fmt`, the input's format.  A .cram output
    raises: CRAM is ROADMAP A13."""
    name = out_path if isinstance(out_path, (str, bytes)) else None
    sfx = (name.decode() if isinstance(name, bytes) else name) or ""
    if sfx.endswith(".cram"):
        raise NotImplementedError(
            "CRAM output is not ported yet (ROADMAP A13): write .bam or "
            ".sam")
    if sfx.endswith(".sam"):
        return "sam"
    if sfx.endswith(".bam"):
        return "bam"
    return default_fmt


def _write_bytes(data, out_path) -> None:
    if isinstance(out_path, (str, bytes)):
        with open(out_path, "wb") as f:
            f.write(data)
    else:
        out_path.write(data)


def _write_alignment_output(bf, out_path, fmt: str) -> None:
    """Serialize the record model as `fmt` ("sam" or "bam")."""
    if fmt == "sam":
        from ..io.sam import serialize_sam
        _write_bytes(serialize_sam(bf), out_path)
    else:
        _write_bytes(serialize_bam(bf, compress=True), out_path)


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
                    timings: dict | None = None) -> dict:
    """BAM or SAM (``.sam``, ``.sam.gz``) -> BAM or SAM recalibration with
    the whole file in host memory.

    The input may be BGZF, plain gzip or raw BAM.  The output format
    follows out_path's extension (an unnamed sink keeps the input's); a
    ``.cram`` output raises NotImplementedError.  use_oq: recalibrate from
    the OQ tags' qualities; set_oq: keep each primary record's original
    qualities in an OQ tag.  checkpoint_dir, report_out and apply_report
    as in ``recalibrate_fastq`` (read groups are the RG tags, in order of
    first appearance over primary records).  device=None means the CUDA
    device (raises without one).  `timings` gets the pipeline's stages and
    the host's: ``read`` (file read and inflate), ``decode`` (index, scan
    and decode), ``rewrite`` and ``write`` (compress and write).
    """
    dev = resolve_device(device)
    is_sam = str(in_path).endswith((".sam", ".sam.gz"))
    fmt = _output_format(out_path, "sam" if is_sam else "bam")
    stamps = [time.time()]

    def mark(name):
        now = time.time()
        if timings is not None:
            timings[name] = round(now - stamps[0], 3)
        stamps[0] = now

    run_kw = dict(device=dev, timings=timings, checkpoint_dir=checkpoint_dir)
    if is_sam:
        bf, primary, arrays, lens, registry = _read_sam_arrays(in_path,
                                                               use_oq)
        mark("read")
        new_quals = _run_or_apply(arrays, config, _registry_names(registry),
                                  report_out, apply_report, **run_kw)
        stamps[0] = time.time()
        for i, rec in enumerate(primary):
            rewrite_quals(rec, new_quals[i][:int(lens[i])], set_oq=set_oq)
        mark("rewrite")
        _write_alignment_output(bf, out_path, fmt)
        mark("write")
        return {"num_reads": len(primary), "total_bases": int(lens.sum()),
                "read_groups": len(registry)}

    from ..io.bam_vec import (decode_machine_chunk, rewrite_quals_chunk,
                              scan_chunk)
    raw = read_bam_bytes(in_path)
    mark("read")
    header_text, refs, buf, offs, sizes = index_bam_bytes(raw)
    _, _, _, max_len, keys = scan_chunk(buf, offs, sizes, config.k)
    registry = {key: i for i, key in enumerate(keys)}
    codes, quals, mask, rgs, seconds, lens, prim = decode_machine_chunk(
        buf, offs, sizes, max_len, registry, use_oq=use_oq)
    arrays = ReadArrays(codes, quals, mask, rgs, seconds)
    mark("decode")
    new_quals = _run_or_apply(arrays, config, _registry_names(registry),
                              report_out, apply_report, **run_kw)
    del arrays, codes, quals, mask
    stamps[0] = time.time()
    records = rewrite_quals_chunk(buf, offs, sizes, prim, lens, new_quals,
                                  set_oq=set_oq)
    del new_quals
    mark("rewrite")
    if fmt == "sam":
        _write_alignment_output(
            BamFile(header_text, refs, _records_of(records)), out_path, fmt)
    else:
        head = np.frombuffer(bam_header_bytes(header_text, refs), np.uint8)
        _write_bytes(bgzf.compress(np.concatenate(
            [head, np.frombuffer(records, np.uint8)])), out_path)
    mark("write")
    return {"num_reads": int(prim.size), "total_bases": int(lens.sum()),
            "read_groups": len(registry)}


def recalibrate_bam_streaming(in_path: str, out_path, config: RecalConfig,
                              use_oq: bool = False, set_oq: bool = False,
                              checkpoint_dir: str | None = None,
                              devices: int | None = None,
                              chunk_records: int | None = None,
                              report_out: str | None = None,
                              apply_report: str | None = None, device=None,
                              timings: dict | None = None,
                              host_cache_bytes: int | None = None,
                              device_cache_bytes: int | None = None) -> dict:
    """BAM -> BAM recalibration with O(chunk) host memory, through the
    windowed engine; the same bytes as ``recalibrate_bam`` for any
    `chunk_records`.  One device: `devices` > 1 raises (ROADMAP A15).  The
    output is BAM: a ``.sam`` or ``.cram`` name raises.
    Arguments as ``recalibrate_bam`` and
    ``stream_resident.recalibrate_bam_stream_resident``."""
    if devices is not None and devices > 1:
        raise NotImplementedError(
            "the multi-device streamed route is not ported yet (ROADMAP "
            "A15): pass devices=1")
    if _output_format(out_path, "bam") != "bam":
        raise ValueError("the streamed route writes BAM; recalibrate_bam "
                         "writes SAM")
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

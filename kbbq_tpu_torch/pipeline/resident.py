"""Device-resident single-device pipeline.

Counterpart of ``kbbq_tpu/pipeline/resident.py::recalibrate_arrays_resident``:
the same four passes and the same output bytes.  The dataset goes to the
device once with plain ``tensor.to(device)``; the passes then work on row
chunks of it, so that no whole-dataset [N, n] lane tensor is ever held
(the output does not depend on the chunk size).  What stays resident across
passes is the hash cache of pass 1: per window the block hash ``h1``, the
32-bit probe ``word`` (0 = invalid window) and one bool plane that holds
first the sampled ``keep`` bit and then, overwritten in place, the trusted
bit.

  pass 1  hash cache and filter A = OR of the sampled windows' words, one
          launch (kernel bloom_or_words, fused entry point)
  pass 2  cached word test against A and the coverage rule in one launch
          (kernel bloom_probe, fused entry point), filter B = OR of the
          trusted windows' words (bloom_or_words)
  pass 3  initial trust = cached word test against B (bloom_probe), the
          correction walk (kernel walk_errors), covariate histogram on the
          device
  host    float64 delta math -> int8 Q' table
  pass 4  one flat gather per base on the device
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..io.batcher import ReadArrays
from ..ops.bloom import bloom_build_words, bloom_query_words
from ..ops.covariate import accumulate_covariates, new_covariate_state
from ..ops.hash_cache import hash_cache_build
from ..ops.inference import infer_errors
from ..ops.recal import apply_recal_table
from ..ops.trusted import trusted_from_cache
from ..oracle.bloom import check_layout_capacity
from ..oracle.covariate import CovariateTables
from ..oracle.gatk import build_recal_table
from ..oracle.kmers import alpha_threshold
from ..oracle.lighter import coverage_thresholds
from ..oracle.pipeline import bloom_params_for
from ..utils.trace import OFF, tracer

# rows per chunk of passes 2-4
DEFAULT_CHUNK_ROWS = 65536


def arrays_to_device(arrays: ReadArrays, dev, trace=OFF):
    """(codes, quals, mask, rgs, seconds) of `arrays` as tensors on `dev`,
    everything past a read's end set to code 4.  The copies are `trace`'s
    ``h2d.copy`` spans (device time) and ``h2d_bytes``."""
    mask = np.ascontiguousarray(arrays.mask)
    codes = np.ascontiguousarray(arrays.codes)
    with trace.span("h2d.copy", device=True):
        mask_d = torch.from_numpy(mask).to(dev)
        codes_d = torch.from_numpy(codes).to(dev)
    # everything past a read's end is code 4, whatever the caller left there
    codes_d = torch.where(mask_d, codes_d, torch.full_like(codes_d, 4))
    rest = (np.ascontiguousarray(arrays.quals),
            np.ascontiguousarray(arrays.rgs, dtype=np.int64),
            np.ascontiguousarray(arrays.seconds, dtype=bool))
    with trace.span("h2d.copy", device=True):
        quals_d, rgs_d, seconds_d = (torch.from_numpy(a).to(dev)
                                     for a in rest)
    trace.count("h2d_bytes",
                mask.nbytes + codes.nbytes + sum(a.nbytes for a in rest))
    return codes_d, quals_d, mask_d, rgs_d, seconds_d


def apply_table_tensor(recal, codes, quals, mask, rgs, seconds,
                       rows: int) -> torch.Tensor:
    """Pass 4: one flat gather per base from the Q' table (int8, a numpy
    array or a tensor), `rows` rows at a time -> new quals int8 [N, L] on
    the data's device."""
    N, L = codes.shape
    recal = torch.as_tensor(recal).to(codes.device)
    out = torch.empty((N, L), dtype=torch.int8, device=codes.device)
    for s in range(0, N, rows):
        e = min(N, s + rows)
        out[s:e] = apply_recal_table(recal, codes[s:e], quals[s:e],
                                     mask[s:e], rgs[s:e], seconds[s:e])
    return out


def apply_table_on_device(recal, codes, quals, mask, rgs, seconds,
                          rows: int, trace=OFF) -> np.ndarray:
    """``apply_table_tensor``, its result copied to the host (`trace`'s
    ``d2h.copy`` span and ``d2h_bytes``)."""
    out = apply_table_tensor(recal, codes, quals, mask, rgs, seconds, rows)
    return to_host(out, trace).numpy()


def to_host(t: torch.Tensor, trace=OFF) -> torch.Tensor:
    """`t` copied to the host: `trace`'s ``d2h.copy`` span (device time)
    and ``d2h_bytes``."""
    with trace.span("d2h.copy", device=True):
        host = t.cpu()
    trace.count("d2h_bytes", t.nbytes)
    return host


def recalibrate_arrays_resident(arrays: ReadArrays, config,
                                timings: dict | None = None,
                                device=None,
                                chunk_rows: int | None = None
                                ) -> np.ndarray:
    """Full pipeline over in-memory arrays -> new quals int8 [N, L].

    device=None means the CUDA device (raises without one); the CPU is used
    only for device="cpu".  If `timings` is given, per-stage wall times (s)
    are recorded into it (setup, h2d, pass1, pass2, pass3, deltas, pass4),
    each closed by a device synchronise, and on a CUDA device beside each
    the peak of allocated device memory while it ran
    (``<stage>_peak_bytes``), and the spans and counters of
    ``utils/trace.py``; without it nothing synchronises but the transfers
    back to the host.  `chunk_rows` (default DEFAULT_CHUNK_ROWS)
    is the number of rows per chunk; the result does not depend on it, and
    ``config.batch_size`` is not read here.
    """
    dev = resolve_device(device)
    with tracer(timings, dev) as trace:
        return _resident_passes(arrays, config, dev, chunk_rows, trace)


def _resident_passes(arrays: ReadArrays, config, dev, chunk_rows, trace
                     ) -> np.ndarray:
    """The body of ``recalibrate_arrays_resident``, its stages opened on
    `trace` and the last closed before it returns."""
    trace.stage("setup")
    k, h = config.k, config.num_hashes
    N, L = arrays.num_reads, arrays.max_len
    rows = int(chunk_rows or DEFAULT_CHUNK_ROWS)

    lens = arrays.read_lengths()
    total_bases = int(lens.sum())
    total_kmers = int(np.maximum(lens - k + 1, 0).sum())
    num_rg = int(arrays.rgs.max(initial=0)) + 1
    alpha, coverage = config.resolve_alpha(total_bases)
    threshold = int(alpha_threshold(alpha))
    t_host = coverage_thresholds(alpha, k)
    params_a, params_b = bloom_params_for(config, total_kmers, alpha,
                                          coverage)
    for p in (params_a, params_b):
        # the device holds packed words only (m/8 bytes per filter)
        check_layout_capacity(p, 33, "single-device resident",
                              "lower the bits per key or split the input")
    la, lb = params_a.log2_m, params_b.log2_m

    trace.stage("h2d")
    codes, quals, mask, rgs, seconds = arrays_to_device(arrays, dev, trace)
    t_table = torch.from_numpy(t_host.astype(np.int32)).to(dev)

    chunks = [(s, min(N, s + rows)) for s in range(0, N, rows)]

    # ---- pass 1: hash cache + filter A (`flag` holds the keep bits)
    trace.stage("pass1")
    h1, word, flag, filt_a = hash_cache_build(codes, 0, k, h, threshold, la,
                                              chunk_rows=rows)

    # ---- pass 2: trusted windows (written over the keep plane) + filter B
    trace.stage("pass2")
    trusted_from_cache(filt_a, h1, word, t_table, k, config.trust_threshold,
                       out=flag)
    filt_b = bloom_build_words(h1, word, flag, lb)
    del filt_a

    # ---- pass 3: walks + covariate histogram
    trace.stage("pass3")
    cov = new_covariate_state(num_rg, L, dev)
    tr0 = bloom_query_words(filt_b, h1, word)
    for s, e in chunks:
        err = infer_errors(filt_b, codes[s:e], k, h, config.ext_cap,
                           trusted0=tr0[s:e])
        accumulate_covariates(cov, codes[s:e], quals[s:e], mask[s:e],
                              rgs[s:e], seconds[s:e], err)
    del tr0, h1, word, flag, filt_b
    tables = CovariateTables(
        num_rg, L, *(to_host(cov[name], trace).numpy() for name in
                     ("cyc_total", "cyc_errors", "din_total", "din_errors")))

    trace.stage("deltas")
    recal_host = build_recal_table(tables)

    # ---- pass 4: gather
    trace.stage("pass4")
    res = apply_table_on_device(recal_host, codes, quals, mask, rgs, seconds,
                                rows, trace)
    trace.stage(None)
    return res

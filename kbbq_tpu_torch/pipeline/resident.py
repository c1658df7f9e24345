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

import time

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

# rows per chunk of passes 2-4
DEFAULT_CHUNK_ROWS = 65536


def arrays_to_device(arrays: ReadArrays, dev):
    """(codes, quals, mask, rgs, seconds) of `arrays` as tensors on `dev`,
    everything past a read's end set to code 4."""
    mask = torch.from_numpy(np.ascontiguousarray(arrays.mask)).to(dev)
    codes = torch.from_numpy(np.ascontiguousarray(arrays.codes)).to(dev)
    # everything past a read's end is code 4, whatever the caller left there
    codes = torch.where(mask, codes, torch.full_like(codes, 4))
    quals = torch.from_numpy(np.ascontiguousarray(arrays.quals)).to(dev)
    rgs = torch.from_numpy(
        np.ascontiguousarray(arrays.rgs, dtype=np.int64)).to(dev)
    seconds = torch.from_numpy(
        np.ascontiguousarray(arrays.seconds, dtype=bool)).to(dev)
    return codes, quals, mask, rgs, seconds


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
                          rows: int) -> np.ndarray:
    """``apply_table_tensor``, its result copied to the host."""
    return apply_table_tensor(recal, codes, quals, mask, rgs, seconds,
                              rows).cpu().numpy()


class StageClock:
    """Per-stage wall times into `timings` (None: records nothing and
    never synchronises).  ``mark(name)`` closes the stage that began at the
    last mark: on a CUDA device it synchronises first and also records the
    peak of allocated device memory while the stage ran
    (``<name>_peak_bytes``)."""

    def __init__(self, timings: dict | None, dev):
        self.timings = timings
        self.cuda = dev.type == "cuda"
        self.dev = dev
        self.last = time.time()
        if timings is not None and self.cuda:
            torch.cuda.reset_peak_memory_stats(dev)

    def mark(self, name: str) -> None:
        if self.timings is None:
            return
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            self.timings[name + "_peak_bytes"] = \
                torch.cuda.max_memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        now = time.time()
        self.timings[name] = round(now - self.last, 3)
        self.last = now


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
    (``<stage>_peak_bytes``); without it nothing synchronises but the
    transfers back to the host.  `chunk_rows` (default DEFAULT_CHUNK_ROWS)
    is the number of rows per chunk; the result does not depend on it, and
    ``config.batch_size`` is not read here.
    """
    dev = resolve_device(device)
    _mark = StageClock(timings, dev).mark

    k, h = config.k, config.num_hashes
    N, L = arrays.num_reads, arrays.max_len
    rows = int(chunk_rows or DEFAULT_CHUNK_ROWS)

    lens = arrays.mask.sum(axis=1)
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
    _mark("setup")

    codes, quals, mask, rgs, seconds = arrays_to_device(arrays, dev)
    t_table = torch.from_numpy(t_host.astype(np.int32)).to(dev)
    _mark("h2d")

    chunks = [(s, min(N, s + rows)) for s in range(0, N, rows)]

    # ---- pass 1: hash cache + filter A (`flag` holds the keep bits)
    h1, word, flag, filt_a = hash_cache_build(codes, 0, k, h, threshold, la,
                                              chunk_rows=rows)
    _mark("pass1")

    # ---- pass 2: trusted windows (written over the keep plane) + filter B
    trusted_from_cache(filt_a, h1, word, t_table, k, config.trust_threshold,
                       out=flag)
    filt_b = bloom_build_words(h1, word, flag, lb)
    del filt_a
    _mark("pass2")

    # ---- pass 3: walks + covariate histogram
    cov = new_covariate_state(num_rg, L, dev)
    tr0 = bloom_query_words(filt_b, h1, word)
    for s, e in chunks:
        err = infer_errors(filt_b, codes[s:e], k, h, config.ext_cap,
                           trusted0=tr0[s:e])
        accumulate_covariates(cov, codes[s:e], quals[s:e], mask[s:e],
                              rgs[s:e], seconds[s:e], err)
    del tr0, h1, word, flag, filt_b
    tables = CovariateTables(
        num_rg, L, *(cov[name].cpu().numpy() for name in
                     ("cyc_total", "cyc_errors", "din_total", "din_errors")))
    _mark("pass3")

    recal_host = build_recal_table(tables)
    _mark("deltas")

    # ---- pass 4: gather
    res = apply_table_on_device(recal_host, codes, quals, mask, rgs, seconds,
                                rows)
    _mark("pass4")
    return res

"""Oracle end-to-end recalibration (the 4-pass structure) and the filter
sizing that every pipeline shares.

Copy of ``kbbq_tpu/oracle/pipeline.py``, in NumPy, single process:

  P1 subsample k-mers -> Bloom A       (deterministic hash-threshold, D5)
  P2 trusted k-mers   -> Bloom B       (coverage rule, D6)
  P3 error inference + covariate accumulation (D7/D8)
  host: delta math -> dense recal table (D9/D10)
  P4 per-base gather -> new quals

This is the port's parity authority: ``pipeline/recalibrate.py`` and every
route beside it must give its bytes.  ``bloom_params_for`` is the one sizing
path of every pipeline (filter size is part of the bit-exact spec).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..constants import (
    DEFAULT_K,
    DEFAULT_NUM_HASHES,
    DEFAULT_SAMPLED_BITS_PER_KEY,
    DEFAULT_TRUSTED_BITS_PER_KEY,
    LIGHTER_ALPHA_NUMERATOR,
    NUM_Q,
)
from .bloom import BloomParams, OracleBloom
from .covariate import (
    CovariateTables,
    accumulate_read,
    compute_skips,
    cycle_indices,
    dinuc_indices,
)
from .gatk import build_recal_table
from .kmers import alpha_threshold, canonical_kmers, sample_hash
from .lighter import infer_read_errors, trusted_kmer_mask


@dataclasses.dataclass
class OracleConfig:
    k: int = DEFAULT_K
    alpha: float | None = None       # None -> 7 / coverage
    coverage: float | None = None    # -c; else computed from genome_length
    genome_length: int | None = None  # -g
    num_hashes: int = DEFAULT_NUM_HASHES
    sampled_bits_per_key: int = DEFAULT_SAMPLED_BITS_PER_KEY
    trusted_bits_per_key: int = DEFAULT_TRUSTED_BITS_PER_KEY
    trust_threshold: int | None = None  # None -> k (D6)
    ext_cap: int | None = None          # None -> DEFAULT_EXT_CAP (D7)
    # floor on both filters' log2_m (WGS pre-sizing / capacity tests);
    # part of the bit-exact spec — oracle and device must agree
    min_log2_m: int | None = None

    def resolve(self, total_bases: int):
        cov = self.coverage
        if cov is None and self.genome_length:
            cov = total_bases / self.genome_length
        if cov is None:
            cov = 30.0
        alpha = self.alpha
        if alpha is None:
            alpha = min(1.0, LIGHTER_ALPHA_NUMERATOR / max(cov, 1.0))
        return alpha, cov


def expected_bloom_keys(total_kmers: int, alpha: float, coverage: float):
    """(filter A keys, filter B keys): DISTINCT k-mer estimates.

    Distinct genomic k-mers ~ total_kmers / coverage (each occurs
    ~coverage times); x2 margin for errors/repeats.  Filter A holds the
    sampled subset (<= alpha x occurrences, <= distinct); filter B the
    trusted set (~distinct).  Part of the bit-exact spec: every pipeline
    must agree (filter size changes FP sets).
    """
    distinct = max(1, int(2.0 * total_kmers / max(1.0, coverage)))
    n_a = max(1, min(int(alpha * total_kmers), distinct))
    n_b = max(1, min(total_kmers, distinct))
    return n_a, n_b


def bloom_params_for(config, total_kmers: int, alpha: float,
                     coverage: float):
    """(params_a, params_b) for a config (duck-typed on the shared sizing
    fields).  THE single sizing path: key estimates via
    expected_bloom_keys, the config's min_log2_m floor applied to both
    filters, and the global 2^MAX_BLOOM_LOG2 addressing ceiling enforced
    (BloomCapacityError past it — never a silent clamp)."""
    n_a, n_b = expected_bloom_keys(total_kmers, alpha, coverage)
    floor = getattr(config, "min_log2_m", None) or 0
    params_a = BloomParams.for_keys(
        n_a, config.sampled_bits_per_key, config.num_hashes,
        min_log2=floor)
    params_b = BloomParams.for_keys(
        n_b, config.trusted_bits_per_key, config.num_hashes,
        min_log2=floor)
    return params_a, params_b


@dataclasses.dataclass
class ReadBatch:
    """Plain list-of-arrays read set used by the oracle."""
    codes: Sequence[np.ndarray]   # int8 base codes per read
    quals: Sequence[np.ndarray]   # int per-base reported quality per read
    rgs: Sequence[int]
    seconds: Sequence[bool]

    def __len__(self):
        return len(self.codes)

    @property
    def total_bases(self):
        return int(sum(len(c) for c in self.codes))

    @property
    def max_len(self):
        return int(max((len(c) for c in self.codes), default=1))

    @property
    def num_rg(self):
        return int(max(self.rgs, default=0)) + 1


def gather_read(recal: np.ndarray, codes, quals, rg: int,
                second: bool) -> np.ndarray:
    """Pass 4 of one read: each base's Q' from the dense table by (read
    group, reported q, cycle, dinuc); skipped bases keep their q."""
    codes = np.asarray(codes, dtype=np.int64)
    quals = np.asarray(quals, dtype=np.int64)
    L = len(codes)
    skips = compute_skips(codes, quals)
    q = np.clip(quals, 0, NUM_Q - 1)
    cyc = cycle_indices(L, second)
    din = dinuc_indices(codes)
    out = recal[rg, q, cyc, din].astype(np.int64)
    return np.where(skips, quals, out)


def recalibrate_reads(batch: ReadBatch, config: OracleConfig = OracleConfig()):
    """Full oracle pipeline. Returns (new_quals list, debug dict)."""
    k = config.k
    alpha, cov = config.resolve(batch.total_bases)
    thresh = alpha_threshold(alpha)

    total_kmers = sum(max(0, len(c) - k + 1) for c in batch.codes)
    sampled_params, trusted_params = bloom_params_for(
        config, total_kmers, alpha, cov)

    # PASS 1: subsample -> Bloom A (per-occurrence Bernoulli, D5)
    bloom_a = OracleBloom(sampled_params)
    for rid, codes in enumerate(batch.codes):
        hi, lo, valid = canonical_kmers(codes, k)
        if hi.size == 0:
            continue
        offs = np.arange(hi.size, dtype=np.uint32)
        keep = valid & (sample_hash(np.uint32(rid), offs) <= thresh)
        bloom_a.insert(hi, lo, mask=keep)

    # PASS 2: trusted kmers -> Bloom B
    bloom_b = OracleBloom(trusted_params)
    for codes in batch.codes:
        tr = trusted_kmer_mask(codes, k, bloom_a, alpha,
                               config.trust_threshold)
        if tr.size == 0 or not tr.any():
            continue
        hi, lo, _ = canonical_kmers(codes, k)
        bloom_b.insert(hi, lo, mask=tr)

    # PASS 3: error inference + covariates
    tables = CovariateTables(batch.num_rg, batch.max_len)
    all_errors = []
    for codes, quals, rg, second in zip(batch.codes, batch.quals,
                                        batch.rgs, batch.seconds):
        errors = infer_read_errors(codes, k, bloom_b, config.ext_cap)
        all_errors.append(errors)
        accumulate_read(tables, codes, quals, errors, rg, second)

    # host delta math -> dense recal table
    recal = build_recal_table(tables)

    # PASS 4: gather
    new_quals = [gather_read(recal, codes, quals, rg, second)
                 for codes, quals, rg, second in zip(
                     batch.codes, batch.quals, batch.rgs, batch.seconds)]

    debug = {
        "alpha": alpha,
        "coverage": cov,
        "tables": tables,
        "recal_table": recal,
        "errors": all_errors,
        "bloom_a": bloom_a,
        "bloom_b": bloom_b,
    }
    return new_quals, debug

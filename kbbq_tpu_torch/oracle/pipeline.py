"""Filter sizing from the dataset's k-mer count (copy of the sizing part of
``kbbq_tpu/oracle/pipeline.py``; part of the bit-exact spec)."""

from __future__ import annotations

from .bloom import BloomParams


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

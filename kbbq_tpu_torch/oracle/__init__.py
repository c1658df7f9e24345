"""Pure-NumPy executable spec of the port (its parity authority).

Copies of ``kbbq_tpu.oracle`` (DECISIONS.md): k-mer packing and hashing,
the byte-per-slot Bloom filter and its sizing, the Lighter trust rule and
walk, covariates, the float64 delta math and the 4-pass
``recalibrate_reads``.  The port keeps its own copy because it imports
nothing of the JAX package; every device path of ``kbbq_tpu_torch`` is held
to it.
"""

from .kmers import (
    encode_seq,
    decode_seq,
    fmix32,
    canonical_kmers,
    kmer_hashes,
    sample_hash,
)
from .bloom import BloomParams, OracleBloom
from .lighter import trusted_kmer_mask, infer_read_errors
from .covariate import CovariateTables, accumulate_read, compute_skips
from .gatk import (
    empirical_quality,
    compute_deltas,
    build_recal_table,
)
from .pipeline import OracleConfig, recalibrate_reads

# the port's host-side users (pipelines, parallel layouts) import these
# from here too
from .bloom import BloomCapacityError, check_layout_capacity
from .gatk import captured_tables
from .kmers import alpha_threshold
from .lighter import coverage_thresholds
from .pipeline import bloom_params_for, expected_bloom_keys

"""Host-side (NumPy/scipy) parts of the executable spec that the port needs.

Copies of the corresponding functions of ``kbbq_tpu.oracle``: filter sizing,
sampling and coverage thresholds, and the float64 delta math are part of the
bit-exact spec, so the port computes them with the same code.
"""

from .bloom import BloomCapacityError, BloomParams, check_layout_capacity
from .covariate import CovariateTables
from .gatk import build_recal_table, captured_tables, compute_deltas
from .kmers import alpha_threshold, decode_seq, encode_seq
from .lighter import coverage_thresholds
from .pipeline import bloom_params_for, expected_bloom_keys

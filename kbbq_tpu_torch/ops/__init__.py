"""Tensor functions of the port (counterparts of ``kbbq_tpu.ops``).

All device arithmetic is integer, so results are invariant to chunking and
order.  Three functions run as hand-written CUDA kernels on CUDA tensors and
as their plain PyTorch versions on CPU tensors: the Bloom probe (alone, or
fused with pass 2's coverage rule behind it), the Bloom build (alone, or
fused with the hash pass in front of it) and the correction walk.
"""

from .bloom import (
    bloom_build_words,
    bloom_query_rows,
    bloom_query_words,
    probe_word,
    probe_words,
)
from .covariate import accumulate_covariates, new_covariate_state
from .hash_cache import hash_cache_build, hash_cache_chunk
from .inference import infer_errors
from .kmers import (
    canonical_kmers_batch,
    fmix32,
    kmer_hashes,
    kmer_lanes_batch,
    sample_keep_mask,
)
from .recal import apply_recal_table
from .trusted import coverage_counts, trusted_from_cache, trusted_mask_batch

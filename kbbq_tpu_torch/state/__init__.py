"""State carried across from the JAX package (as numpy arrays)."""

from .convert import (
    bloom_from_numpy,
    bloom_from_slots,
    bloom_to_numpy,
    hash_cache_from_numpy,
    recal_from_numpy,
    tables_from_numpy,
)

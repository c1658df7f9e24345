"""Bloom filter sizing (DECISIONS.md D3/D4).

Copy of the sizing part of ``kbbq_tpu/oracle/bloom.py``: the filter size is
part of the bit-exact spec (it decides the false-positive set), so the port
sizes its filters with the same code.  The blocked layout addresses up to
2^MAX_BLOOM_LOG2 slots; sizing past that, or past a layout's own ceiling,
raises BloomCapacityError instead of silently clamping.
"""

from __future__ import annotations

import dataclasses
import math

from ..constants import (
    DEFAULT_NUM_HASHES,
    MAX_BLOOM_LOG2,
    MIN_BLOOM_LOG2,
)


class BloomCapacityError(ValueError):
    """Filter sizing exceeds a layout's addressable/physical capacity."""


@dataclasses.dataclass(frozen=True)
class BloomParams:
    log2_m: int
    num_hashes: int = DEFAULT_NUM_HASHES

    @property
    def m(self) -> int:
        return 1 << self.log2_m

    @staticmethod
    def for_keys(expected_keys: int, slots_per_key: int,
                 num_hashes: int = DEFAULT_NUM_HASHES,
                 min_log2: int = 0) -> "BloomParams":
        slots = max(1, expected_keys) * slots_per_key
        log2_m = max(MIN_BLOOM_LOG2, min_log2,
                     math.ceil(math.log2(max(2, slots))))
        if log2_m > MAX_BLOOM_LOG2:
            raise BloomCapacityError(
                f"Bloom filter for {expected_keys:.3g} keys x "
                f"{slots_per_key} slots/key needs 2^{log2_m} slots, over "
                f"the blocked layout's 2^{MAX_BLOOM_LOG2} addressing "
                f"ceiling — reduce bits/key or split the input")
        return BloomParams(log2_m=log2_m, num_hashes=num_hashes)

    def fpr(self, inserted_keys: int) -> float:
        """Classic Bloom FPR estimate for the current sizing."""
        m, h = self.m, self.num_hashes
        return (1.0 - math.exp(-h * inserted_keys / m)) ** h


def check_layout_capacity(params: BloomParams, max_log2: int,
                          layout: str, hint: str) -> None:
    """Raise loudly when a filter exceeds its LAYOUT's capacity."""
    if params.log2_m > max_log2:
        raise BloomCapacityError(
            f"Bloom filter needs 2^{params.log2_m} slots "
            f"({(1 << params.log2_m) >> 33} GiB packed), over the "
            f"{layout} layout's 2^{max_log2}-slot capacity — {hint}")

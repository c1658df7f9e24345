"""Oracle Bloom filter and its sizing (DECISIONS.md D3/D4).

Copy of ``kbbq_tpu/oracle/bloom.py``: the filter size is part of the
bit-exact spec (it decides the false-positive set), so the port sizes its
filters with the same code, and ``OracleBloom`` is the byte-per-slot
filter the spec's passes insert into and query.  The blocked layout
addresses up to 2^MAX_BLOOM_LOG2 slots; sizing past that, or past a
layout's own ceiling, raises BloomCapacityError instead of silently
clamping.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..constants import (
    DEFAULT_NUM_HASHES,
    MAX_BLOOM_LOG2,
    MIN_BLOOM_LOG2,
)
from .kmers import kmer_hashes, probe_positions


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


# sparse-storage threshold: an m-byte dense oracle array past 2 GiB is
# wasteful for the toy key counts large-filter TESTS use
_DENSE_SLOT_LIMIT = 1 << 31


class OracleBloom:
    """NumPy byte-per-slot Bloom filter over (hi, lo) uint32 k-mer lanes.

    Filters past 2^31 slots store the SET of set positions instead of a
    dense byte array — bit-identical semantics (positions are exact),
    O(inserted keys) memory, so WGS-sized log2_m values are testable at
    toy read counts.
    """

    def __init__(self, params: BloomParams):
        self.params = params
        if params.m <= _DENSE_SLOT_LIMIT:
            self.slots = np.zeros(params.m, dtype=np.uint8)
            self._set = None
        else:
            self.slots = None
            self._set: set[int] | None = set()

    def _positions(self, hi, lo):
        h1, h2 = kmer_hashes(hi, lo)
        return probe_positions(h1, h2, self.params.num_hashes,
                               self.params.log2_m)

    def insert(self, hi, lo, mask=None):
        """Insert k-mers; mask selects which entries to insert (bool [...])."""
        pos = self._positions(hi, lo)  # [..., h]
        if mask is not None:
            pos = pos[np.asarray(mask, dtype=bool)]
        if self._set is None:
            self.slots[pos.reshape(-1)] = 1
        else:
            self._set.update(pos.reshape(-1).tolist())

    def query(self, hi, lo) -> np.ndarray:
        """Membership per k-mer: bool [...]. All h probe slots must be set."""
        pos = self._positions(hi, lo)
        if self._set is None:
            return self.slots[pos].all(axis=-1)
        flat = pos.reshape(-1, pos.shape[-1])
        out = np.fromiter(
            (all(int(p) in self._set for p in row) for row in flat),
            dtype=bool, count=flat.shape[0])
        return out.reshape(pos.shape[:-1])

"""Whole-dataset fixed-shape host arrays (counterpart of
``kbbq_tpu/io/batcher.py``).

The port moves the dataset to the device once and works on row chunks of
it, so only ``ReadArrays`` is carried over; a read's global ordinal (its
row) keys the per-occurrence sampling hash (DECISIONS.md D5).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ReadArrays:
    """Whole-dataset fixed-shape arrays (host, NumPy)."""

    codes: np.ndarray    # int8  [N, Lmax]   (4 = N/pad)
    quals: np.ndarray    # int8  [N, Lmax]
    mask: np.ndarray     # bool  [N, Lmax]   (True = real base)
    rgs: np.ndarray      # int32 [N]
    seconds: np.ndarray  # bool  [N]

    @property
    def num_reads(self) -> int:
        return int(self.codes.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.codes.shape[1])

    @staticmethod
    def from_lists(codes_list, quals_list, rgs, seconds,
                   max_len: int | None = None) -> "ReadArrays":
        n = len(codes_list)
        L = int(max_len or max((len(c) for c in codes_list), default=1))
        codes = np.full((n, L), 4, dtype=np.int8)
        quals = np.zeros((n, L), dtype=np.int8)
        mask = np.zeros((n, L), dtype=bool)
        for i, (c, q) in enumerate(zip(codes_list, quals_list)):
            m = len(c)
            codes[i, :m] = c
            quals[i, :m] = q
            mask[i, :m] = True
        return ReadArrays(codes, quals, mask,
                          np.asarray(rgs, dtype=np.int32),
                          np.asarray(seconds, dtype=bool))

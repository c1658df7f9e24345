"""Whole-dataset fixed-shape host arrays (counterpart of
``kbbq_tpu/io/batcher.py``).

The port moves the dataset to the device once and works on row chunks of
it, so only ``ReadArrays`` is carried over; a read's global ordinal (its
row) keys the per-occurrence sampling hash (DECISIONS.md D5).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.trace import count_open


@dataclasses.dataclass
class ReadArrays:
    """Whole-dataset fixed-shape arrays (host, NumPy).  `lens` is given by
    the producers that know the read lengths (the FASTQ and BAM decodes,
    ``from_lists``); read them through ``read_lengths``."""

    codes: np.ndarray    # int8  [N, Lmax]   (4 = N/pad)
    quals: np.ndarray    # int8  [N, Lmax]
    mask: np.ndarray     # bool  [N, Lmax]   (True = real base)
    rgs: np.ndarray      # int32 [N]
    seconds: np.ndarray  # bool  [N]
    lens: np.ndarray | None = None  # int64 [N] = mask.sum(axis=1)

    def read_lengths(self) -> np.ndarray:
        """int64 [N] read lengths: `lens`, or where the producer gave none,
        the mask's row sums, summed once and kept.  Counts the sums on the
        tracer of the job running in this context (``utils/trace.py``,
        ``arrays.lens_from_mask``: 0 where `lens` was given)."""
        summed = self.lens is None
        if summed:
            self.lens = self.mask.sum(axis=1, dtype=np.int64)
        count_open("arrays.lens_from_mask", int(summed))
        return self.lens

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
        lens = np.zeros(n, dtype=np.int64)
        for i, (c, q) in enumerate(zip(codes_list, quals_list)):
            m = len(c)
            codes[i, :m] = c
            quals[i, :m] = q
            mask[i, :m] = True
            lens[i] = m
        return ReadArrays(codes, quals, mask,
                          np.asarray(rgs, dtype=np.int32),
                          np.asarray(seconds, dtype=bool), lens)

"""Conversion of the JAX package's state into the port's.

There are no weights: the state of a run is the two Bloom filters, the hash
cache, the covariate tables and the Q' table.  The functions here take that
state AS NUMPY ARRAYS (the caller does the ``np.asarray`` on the JAX side;
this module imports nothing of ``kbbq_tpu``) and return the port's form, so
that, say, a filter built by the JAX package can be probed and walked by
the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle.covariate import CovariateTables


def bloom_from_numpy(packed_u32: np.ndarray, device="cpu") -> torch.Tensor:
    """Packed filter uint32 [m/32] (``bloom_rows`` / ``bloom_rows_dense``
    of the JAX package) -> contiguous int32 tensor with the same bits."""
    a = np.ascontiguousarray(packed_u32, dtype=np.uint32)
    if a.ndim != 1 or a.size == 0 or a.size & (a.size - 1):
        raise ValueError("packed filter must be 1-D, power-of-two words")
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def bloom_to_numpy(packed: torch.Tensor) -> np.ndarray:
    """The port's packed filter -> uint32 [m/32] numpy array."""
    return packed.detach().cpu().contiguous().numpy().view(np.uint32)


def bloom_from_slots(slots_u8: np.ndarray, device="cpu") -> torch.Tensor:
    """Byte-per-slot staging view uint8 [m] (``bloom_insert`` of the JAX
    package, the oracle's ``OracleBloom.slots``) -> packed int32 tensor:
    word b's bit j = slots[b*32 + j]."""
    s = np.ascontiguousarray(slots_u8, dtype=np.uint8)
    if s.ndim != 1 or s.size % 32:
        raise ValueError("slots must be 1-D with a multiple of 32 entries")
    words = np.packbits(s.reshape(-1, 32) != 0, axis=1, bitorder="little")
    return bloom_from_numpy(words.view("<u4").reshape(-1), device)


def hash_cache_from_numpy(h1_u32: np.ndarray, word_u32: np.ndarray,
                          keep: np.ndarray, device="cpu"):
    """The pass-1 hash cache (h1, word, keep) of the JAX package's
    ``_pass1_kmers_slice`` -> (int32, int32, bool) tensors, shapes kept."""
    def u(a):
        a = np.ascontiguousarray(a, dtype=np.uint32)
        return torch.from_numpy(a.view(np.int32).copy()).to(device)
    k = torch.from_numpy(np.ascontiguousarray(keep, dtype=bool).copy())
    return u(h1_u32), u(word_u32), k.to(device)


def tables_from_numpy(cyc_total, cyc_errors, din_total,
                      din_errors) -> CovariateTables:
    """Covariate counters [rg, NUM_Q, 2*max_len] / [rg, NUM_Q, 16] (int32
    device state or int64 totals of the JAX package) -> the port's int64
    CovariateTables."""
    ct = np.asarray(cyc_total, dtype=np.int64)
    return CovariateTables(
        int(ct.shape[0]), int(ct.shape[2]) // 2, ct.copy(),
        np.asarray(cyc_errors, dtype=np.int64).copy(),
        np.asarray(din_total, dtype=np.int64).copy(),
        np.asarray(din_errors, dtype=np.int64).copy())


def recal_from_numpy(table_i8: np.ndarray, device="cpu") -> torch.Tensor:
    """The int8 Q' table [rg, NUM_Q, 2*max_len, 17] of ``build_recal_table``
    -> int8 tensor for ``ops.recal.apply_recal_table``."""
    t = np.ascontiguousarray(table_i8, dtype=np.int8)
    if t.ndim != 4:
        raise ValueError("recal table must be [rg, q, cycle, dinuc]")
    return torch.from_numpy(t.copy()).to(device)

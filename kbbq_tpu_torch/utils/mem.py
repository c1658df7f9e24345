"""Large host buffers whose first touch faults 2 MB pages.

Counterpart of ``kbbq_tpu/utils/mem.py``.  A fresh multi-megabyte NumPy
array is filled page by page on first touch; with ``MADV_HUGEPAGE`` on its
pages (transparent huge pages in madvise mode) the kernel faults 2 MB at a
time instead of 4 KB, about 500 times fewer faults for the padded FASTQ
arrays of a window.  Where libc or the advice is missing the buffer is a
plain ``np.empty``: the advice changes the cost of the fill, never its
result.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_MADV_HUGEPAGE = 14
_HP = 2 << 20                     # transparent huge page size


@functools.lru_cache(maxsize=None)
def _madvise():
    """libc's madvise, bound at first use; None where there is no glibc."""
    try:
        fn = ctypes.CDLL("libc.so.6", use_errno=True).madvise
    except OSError:
        return None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def madvise_hugepage(arr: np.ndarray) -> None:
    """Advise MADV_HUGEPAGE over an array's pages (arrays of 4 MB and up)."""
    madvise = _madvise()
    if madvise is None or arr.nbytes < (4 << 20):
        return
    addr = arr.ctypes.data
    base = addr & ~(_HP - 1)
    madvise(base, arr.nbytes + (addr - base), _MADV_HUGEPAGE)


def hugepage_empty(shape, dtype) -> np.ndarray:
    """np.empty whose first touch faults 2 MB pages instead of 4 KB."""
    a = np.empty(shape, dtype)
    madvise_hugepage(a)
    return a

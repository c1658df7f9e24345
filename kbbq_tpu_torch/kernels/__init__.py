"""Build, ctypes binding and wrappers of ``csrc/kbbq_kernels.cu``.

The three kernels (``bloom_probe`` with its two entry points,
``bloom_or_words``, ``walk_errors``) are CUDA C++ for sm_90a with a plain C
interface.  ``build()`` compiles them with nvcc into
``kbbq_tpu_torch/build/libkbbq_kernels.so`` at first use (and again when
the source is newer); the library is loaded with ctypes.  Nothing here
runs at import time, so the module imports on a machine without nvcc or a
card.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with torch, launches on torch's current stream, raises on a
non-zero return, and adds one to its entry in ``LAUNCHES`` where it
launches its kernel.  A build or launch failure raises; nothing falls back
to the plain PyTorch versions (those live beside their callers in
``kbbq_tpu_torch.ops`` and serve CPU tensors only).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "kbbq_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD_DIR, "libkbbq_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches per kernel since the last reset_launches()
LAUNCHES = {"bloom_probe": 0, "bloom_or_words": 0, "walk_errors": 0}

_lib = None
build_log = ""       # nvcc's output of the last build (registers, spills)
build_seconds = 0.0  # wall time of the last build, 0 when the library was fresh


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of kbbq_tpu_torch "
                       "cannot be built (looked on PATH, in $CUDA_HOME/bin "
                       "and in /usr/local/cuda/bin)")


def build() -> str:
    """Compile the kernels if the library is missing or older than the
    source; returns the library's path.  Raises on a failed build."""
    global build_log, build_seconds
    fresh = (os.path.isfile(LIBRARY)
             and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE))
    if fresh:
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.time() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, LIBRARY)   # atomic: a concurrent build never half-loads
    return LIBRARY


def _bind(lib) -> None:
    p, i, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint32)
    lib.kbbq_bloom_probe_hashed.argtypes = [p, u32, p, p, p, i64, i, p]
    lib.kbbq_bloom_probe_words.argtypes = [p, u32, p, p, p, i64, p]
    lib.kbbq_bloom_or_words.argtypes = [p, u32, p, p, p, i64, p]
    lib.kbbq_walk_errors.argtypes = [p, p, p, u32, p, i64, i, i, i, i, p]
    for fn in (lib.kbbq_bloom_probe_hashed, lib.kbbq_bloom_probe_words,
               lib.kbbq_bloom_or_words, lib.kbbq_walk_errors):
        fn.restype = ctypes.c_int


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        _bind(lib)
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _block_mask(packed: torch.Tensor) -> int:
    words = int(packed.shape[0]) if packed.dim() == 1 else 0
    if words < 1 or words & (words - 1) or words > (1 << 31):
        raise ValueError("packed filter must be 1-D with a power-of-two "
                         "number of words (at most 2^31)")
    return words - 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {rc}")


def bloom_probe_hashed(packed: torch.Tensor, hi: torch.Tensor,
                       lo: torch.Tensor, num_hashes: int) -> torch.Tensor:
    """Kernel bloom_probe, hashed entry point: membership of the canonical
    k-mers (hi, lo) in the packed filter.  packed int32 [m/32]; hi, lo int32
    patterns of one shape; returns bool of that shape."""
    dev = packed.device
    _check(packed, "packed", torch.int32, dev)
    _check(hi, "hi", torch.int32, dev)
    _check(lo, "lo", torch.int32, dev)
    if hi.shape != lo.shape:
        raise ValueError("hi and lo must have one shape")
    mask = _block_mask(packed)
    out = torch.empty(hi.shape, dtype=torch.bool, device=dev)
    if hi.numel() == 0:
        return out          # nothing to launch, nothing counted
    with torch.cuda.device(dev):
        rc = library().kbbq_bloom_probe_hashed(
            packed.data_ptr(), mask, hi.data_ptr(), lo.data_ptr(),
            out.data_ptr(), hi.numel(), int(num_hashes), _stream())
    _raise_on(rc, "bloom_probe")
    LAUNCHES["bloom_probe"] += 1
    return out


def bloom_probe_words(packed: torch.Tensor, h1: torch.Tensor,
                      word: torch.Tensor) -> torch.Tensor:
    """Kernel bloom_probe, cached entry point:
    ``(packed[h1 & mask] & word) == word and word != 0`` per element."""
    dev = packed.device
    _check(packed, "packed", torch.int32, dev)
    _check(h1, "h1", torch.int32, dev)
    _check(word, "word", torch.int32, dev)
    if h1.shape != word.shape:
        raise ValueError("h1 and word must have one shape")
    mask = _block_mask(packed)
    out = torch.empty(h1.shape, dtype=torch.bool, device=dev)
    if h1.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = library().kbbq_bloom_probe_words(
            packed.data_ptr(), mask, h1.data_ptr(), word.data_ptr(),
            out.data_ptr(), h1.numel(), _stream())
    _raise_on(rc, "bloom_probe")
    LAUNCHES["bloom_probe"] += 1
    return out


def bloom_or_words(packed: torch.Tensor, h1: torch.Tensor,
                   word: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Kernel bloom_or_words: ``packed[h1 & mask] |= word`` where `keep`,
    IN PLACE on `packed` (which it returns)."""
    dev = packed.device
    _check(packed, "packed", torch.int32, dev)
    _check(h1, "h1", torch.int32, dev)
    _check(word, "word", torch.int32, dev)
    _check(keep, "keep", torch.bool, dev)
    if not (h1.shape == word.shape == keep.shape):
        raise ValueError("h1, word and keep must have one shape")
    mask = _block_mask(packed)
    if h1.numel() == 0:
        return packed
    with torch.cuda.device(dev):
        rc = library().kbbq_bloom_or_words(
            packed.data_ptr(), mask, h1.data_ptr(), word.data_ptr(),
            keep.data_ptr(), h1.numel(), _stream())
    _raise_on(rc, "bloom_or_words")
    LAUNCHES["bloom_or_words"] += 1
    return packed


def walk_errors(codes: torch.Tensor, trusted0: torch.Tensor,
                packed: torch.Tensor, k: int, W: int,
                num_hashes: int) -> torch.Tensor:
    """Kernel walk_errors: the whole correction walk of every read in one
    launch.  codes int8 [N, L]; trusted0 bool [N, L-k+1] (initial trust of
    every window, query & valid); packed int32 [m/32]; returns the error
    mask bool [N, L].  `codes` is not modified: the kernel works on a copy.
    """
    dev = codes.device
    _check(codes, "codes", torch.int8, dev)
    _check(trusted0, "trusted0", torch.bool, dev)
    _check(packed, "packed", torch.int32, dev)
    if codes.dim() != 2:
        raise ValueError("codes must be [N, L]")
    N, L = codes.shape
    if not 1 <= k <= 32 or not 1 <= W <= k or num_hashes < 1:
        raise ValueError("need 1 <= k <= 32, 1 <= W <= k, num_hashes >= 1")
    if L - k + 1 < 1 or tuple(trusted0.shape) != (N, L - k + 1):
        raise ValueError("trusted0 must be [N, L-k+1] with L >= k")
    mask = _block_mask(packed)
    # the scratch copy may be freed on return: torch's allocator reuses it
    # only in stream order, and the kernel runs on the current stream
    work = codes.clone()
    err = torch.zeros((N, L), dtype=torch.bool, device=dev)
    if N == 0:
        return err
    with torch.cuda.device(dev):
        rc = library().kbbq_walk_errors(
            work.data_ptr(), trusted0.data_ptr(), packed.data_ptr(), mask,
            err.data_ptr(), N, L, int(k), int(W), int(num_hashes), _stream())
    _raise_on(rc, "walk_errors")
    LAUNCHES["walk_errors"] += 1
    return err

"""Build, ctypes binding and wrappers of ``csrc/kbbq_kernels.cu``.

The three kernels (``bloom_probe`` with three entry points,
``bloom_or_words`` with two, the fused one also in a hash-only mode,
``walk_errors``) are CUDA C++ for sm_90a with a plain C interface.  ``build()`` compiles them with nvcc into
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

# launches per kernel since the last reset_launches(), and the same launches
# split by entry point (C function)
LAUNCHES = {"bloom_probe": 0, "bloom_or_words": 0, "walk_errors": 0}
ENTRY_LAUNCHES = {"bloom_probe_hashed": 0, "bloom_probe_words": 0,
                  "bloom_probe_trust": 0, "bloom_or_words": 0,
                  "hash_build": 0, "hash_only": 0, "walk_errors": 0}

# reads per block of the tiled kernels and threads per block of the walk and
# of the fused trust probe (in both a warp works on one read at a time),
# settled by measuring on an H100 at 150-base reads (PERF.md); the rows are
# halved for reads so long that a tile of this many would not fit a block's
# shared memory
WALK_TILE_ROWS = 32
WALK_THREADS = 128
HASH_TILE_ROWS = 32
TRUST_TILE_ROWS = 16
TRUST_THREADS = 256
MAX_SHARED_BYTES = 232448

_lib = None
build_log = ""       # nvcc's output of the last build (registers, spills)
build_seconds = 0.0  # wall time of the last build, 0 when the library was fresh


def reset_launches() -> None:
    for counts in (LAUNCHES, ENTRY_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _count(kernel: str, entry: str) -> None:
    LAUNCHES[kernel] += 1
    ENTRY_LAUNCHES[entry] += 1


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
    lib.kbbq_bloom_probe_trust.argtypes = [p, u32, p, p, p, p, i64, i, i, i,
                                           i, i, p]
    lib.kbbq_bloom_or_words.argtypes = [p, u32, p, p, p, i64, p]
    lib.kbbq_hash_build.argtypes = [p, p, u32, p, p, p, i64, i64, i, i, i,
                                    u32, i, p]
    lib.kbbq_hash_only.argtypes = [p, p, p, i64, i, i, i, i, p]
    lib.kbbq_walk_errors.argtypes = [p, p, p, u32, p, i64, i, i, i, i, i, i,
                                     p]
    lib.kbbq_walk_tile_bytes.argtypes = [i, i, i]
    lib.kbbq_hash_tile_bytes.argtypes = [i, i, i]
    lib.kbbq_trust_tile_bytes.argtypes = [i, i, i, i]
    lib.kbbq_empty_launch.argtypes = [p]
    for fn in (lib.kbbq_bloom_probe_hashed, lib.kbbq_bloom_probe_words,
               lib.kbbq_bloom_probe_trust, lib.kbbq_bloom_or_words,
               lib.kbbq_hash_build, lib.kbbq_hash_only, lib.kbbq_walk_errors,
               lib.kbbq_walk_tile_bytes, lib.kbbq_hash_tile_bytes,
               lib.kbbq_trust_tile_bytes, lib.kbbq_empty_launch):
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
    _count("bloom_probe", "bloom_probe_hashed")
    return out


def _out_like(x: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """`out` checked (bool, contiguous, the shape and device of `x`), or a
    new tensor of that kind."""
    if out is None:
        return torch.empty(x.shape, dtype=torch.bool, device=x.device)
    _check(out, "out", torch.bool, x.device)
    if out.shape != x.shape:
        raise ValueError(f"out must have shape {tuple(x.shape)}")
    return out


def bloom_probe_words(packed: torch.Tensor, h1: torch.Tensor,
                      word: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel bloom_probe, cached entry point:
    ``(packed[h1 & mask] & word) == word and word != 0`` per element, into
    `out` when given.  Any base pointers are taken: 16-byte loads need h1
    and word congruent modulo 16, 4-byte stores an output that follows
    them modulo 4."""
    dev = packed.device
    _check(packed, "packed", torch.int32, dev)
    _check(h1, "h1", torch.int32, dev)
    _check(word, "word", torch.int32, dev)
    if h1.shape != word.shape:
        raise ValueError("h1 and word must have one shape")
    mask = _block_mask(packed)
    out = _out_like(h1, out)
    if h1.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = library().kbbq_bloom_probe_words(
            packed.data_ptr(), mask, h1.data_ptr(), word.data_ptr(),
            out.data_ptr(), h1.numel(), _stream())
    _raise_on(rc, "bloom_probe")
    _count("bloom_probe", "bloom_probe_words")
    return out


def _fit_tile_rows(tile_bytes, L: int, k: int, rows: int) -> int:
    """The largest tile of at most `rows` reads whose shared memory
    (`tile_bytes(L, k, rows)`, the kernel's own formula) fits a block."""
    while rows > 1 and tile_bytes(L, k, rows) > MAX_SHARED_BYTES:
        rows //= 2
    if tile_bytes(L, k, rows) > MAX_SHARED_BYTES:
        raise ValueError(f"reads of {L} bases do not fit a block's shared "
                         f"memory ({MAX_SHARED_BYTES} bytes)")
    return rows


def bloom_probe_trust(packed: torch.Tensor, h1: torch.Tensor,
                      word: torch.Tensor, thresholds: torch.Tensor, k: int,
                      trust_threshold: int,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel bloom_probe, fused entry point of pass 2: the cached word test
    of every window against `packed` and the coverage rule on its answers,
    in one launch.  h1, word int32 patterns [N, n] (word == 0: window with
    an N); thresholds int32 [k+1], the table t(x); a window is trusted when
    it is valid and at least `trust_threshold` of its k bases are covered.
    Returns bool [N, n], written into `out` when given (every byte of it);
    N == 0 or n == 0 launches nothing."""
    dev = packed.device
    _check(packed, "packed", torch.int32, dev)
    _check(h1, "h1", torch.int32, dev)
    _check(word, "word", torch.int32, dev)
    _check(thresholds, "thresholds", torch.int32, dev)
    if h1.dim() != 2 or h1.shape != word.shape:
        raise ValueError("h1 and word must be [N, n], of one shape")
    if not 1 <= k <= 32 or tuple(thresholds.shape) != (k + 1,):
        raise ValueError("need 1 <= k <= 32 and thresholds of k+1 entries")
    out = _out_like(h1, out)
    mask = _block_mask(packed)
    N, n = h1.shape
    if N == 0 or n == 0:
        return out
    with torch.cuda.device(dev):
        lib = library()
        rows = _fit_tile_rows(
            lambda L, k, r: lib.kbbq_trust_tile_bytes(L, k, r, TRUST_THREADS),
            n + int(k) - 1, int(k), TRUST_TILE_ROWS)
        rc = lib.kbbq_bloom_probe_trust(
            packed.data_ptr(), mask, h1.data_ptr(), word.data_ptr(),
            thresholds.data_ptr(), out.data_ptr(), N, n, int(k),
            int(trust_threshold), rows, TRUST_THREADS, _stream())
    _raise_on(rc, "bloom_probe (trust)")
    _count("bloom_probe", "bloom_probe_trust")
    return out


def bloom_or_words(packed: torch.Tensor, h1: torch.Tensor,
                   word: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Kernel bloom_or_words, cached entry point: ``packed[h1 & mask] |=
    word`` where `keep`, IN PLACE on `packed` (which it returns).  A window
    whose bits are all set already costs a read of its filter word and no
    atomic."""
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
    _count("bloom_or_words", "bloom_or_words")
    return packed


def hash_build(codes: torch.Tensor, packed: torch.Tensor, first_id: int,
               k: int, num_hashes: int, threshold: int):
    """Kernel bloom_or_words, fused entry point: the hash cache of every
    window of `codes` and the sampled build in one launch.

    codes int8 [N, L] with everything past a read's end code 4; packed int32
    [m/32], zeroed or partly built, updated IN PLACE; first_id the global
    ordinal of read 0; threshold the inclusive keep threshold in [0, 2^32).
    Returns (h1, word, keep): int32 patterns [N, n] x2 and bool [N, n],
    n = L-k+1 (n <= 0: empty [N, 0] tensors and no launch); word == 0 marks
    a window with an N, whose h1 is the hash of the window with each N read
    as base 0.  Every insert is a plain atomic here: the sampled windows
    of pass 1 seldom repeat, and testing first measured slower (PERF.md)."""
    dev = codes.device
    _check(codes, "codes", torch.int8, dev)
    _check(packed, "packed", torch.int32, dev)
    if codes.dim() != 2:
        raise ValueError("codes must be [N, L]")
    if not 1 <= k <= 32 or num_hashes < 1:
        raise ValueError("need 1 <= k <= 32 and num_hashes >= 1")
    if not 0 <= threshold < (1 << 32):
        raise ValueError("threshold must lie in [0, 2^32)")
    N, L = codes.shape
    n = max(L - k + 1, 0)
    mask = _block_mask(packed)
    h1 = torch.empty((N, n), dtype=torch.int32, device=dev)
    word = torch.empty((N, n), dtype=torch.int32, device=dev)
    keep = torch.empty((N, n), dtype=torch.bool, device=dev)
    if N == 0 or n == 0:
        return h1, word, keep
    with torch.cuda.device(dev):
        lib = library()
        rows = _fit_tile_rows(lib.kbbq_hash_tile_bytes, L, int(k),
                              HASH_TILE_ROWS)
        rc = lib.kbbq_hash_build(
            codes.data_ptr(), packed.data_ptr(), mask, h1.data_ptr(),
            word.data_ptr(), keep.data_ptr(), N, int(first_id), L, int(k),
            int(num_hashes), int(threshold), rows, _stream())
    _raise_on(rc, "bloom_or_words (hash_build)")
    _count("bloom_or_words", "hash_build")
    return h1, word, keep


def hash_only(codes: torch.Tensor, k: int, num_hashes: int):
    """Kernel bloom_or_words, fused entry point in its hash-only mode: the
    (h1, word) pair of every window of `codes`, with no sampling and no
    filter (passes 2 and 3 of the windowed engine re-hash each window).

    codes int8 [N, L] with everything past a read's end code 4.  Returns
    int32 patterns [N, n] x2, n = L-k+1 (n <= 0: empty [N, 0] tensors and
    no launch); word == 0 marks a window with an N, whose h1 is the hash of
    the window with each N read as base 0 — the h1 and word of
    ``hash_build``."""
    dev = codes.device
    _check(codes, "codes", torch.int8, dev)
    if codes.dim() != 2:
        raise ValueError("codes must be [N, L]")
    if not 1 <= k <= 32 or num_hashes < 1:
        raise ValueError("need 1 <= k <= 32 and num_hashes >= 1")
    N, L = codes.shape
    n = max(L - k + 1, 0)
    h1 = torch.empty((N, n), dtype=torch.int32, device=dev)
    word = torch.empty((N, n), dtype=torch.int32, device=dev)
    if N == 0 or n == 0:
        return h1, word
    with torch.cuda.device(dev):
        lib = library()
        rows = _fit_tile_rows(lib.kbbq_hash_tile_bytes, L, int(k),
                              HASH_TILE_ROWS)
        rc = lib.kbbq_hash_only(codes.data_ptr(), h1.data_ptr(),
                                word.data_ptr(), N, L, int(k),
                                int(num_hashes), rows, _stream())
    _raise_on(rc, "bloom_or_words (hash_only)")
    _count("bloom_or_words", "hash_only")
    return h1, word


def walk_errors(codes: torch.Tensor, trusted0: torch.Tensor,
                packed: torch.Tensor, k: int, W: int,
                num_hashes: int) -> torch.Tensor:
    """Kernel walk_errors: the whole correction walk of every read in one
    launch.  codes int8 [N, L]; trusted0 bool [N, L-k+1] (initial trust of
    every window, query & valid); packed int32 [m/32]; returns the error
    mask bool [N, L].  `codes` is only read: the kernel's working copy of a
    read lives in shared memory, and it writes every byte of the mask."""
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
    err = torch.empty((N, L), dtype=torch.bool, device=dev)
    if N == 0:
        return err
    with torch.cuda.device(dev):
        lib = library()
        rows = _fit_tile_rows(lib.kbbq_walk_tile_bytes, L, int(k),
                              WALK_TILE_ROWS)
        rc = lib.kbbq_walk_errors(
            codes.data_ptr(), trusted0.data_ptr(), packed.data_ptr(), mask,
            err.data_ptr(), N, L, int(k), int(W), int(num_hashes), rows,
            WALK_THREADS, _stream())
    _raise_on(rc, "walk_errors")
    _count("walk_errors", "walk_errors")
    return err


def empty_launch() -> None:
    """Launch a kernel that does nothing (the floor under a launch's time).
    Not a kernel of any path: nothing is counted."""
    rc = library().kbbq_empty_launch(_stream())
    _raise_on(rc, "empty_launch")

"""kbbq_tpu_torch: the PyTorch/CUDA port of kbbq-tpu for NVIDIA Hopper.

Reference-free base quality score recalibration (GATK-style BQSR driven by
Lighter-style k-mer error detection).  This package is the port of the JAX
package ``kbbq_tpu`` that sits beside it: same sub-package and function
names, same output bytes, PyTorch idiom inside.  It imports ``torch``,
``numpy``, ``scipy`` and the standard library, and nothing of ``kbbq_tpu``.

- ``oracle``   — the host-side pieces of the NumPy spec that the device path
                 needs (filter sizing, coverage thresholds, float64 delta math).
- ``io``       — FASTQ reader/writer (native C++ codec ``csrc/kbbq_io.cc``,
                 built with g++ at first use), BGZF, chunked reads,
                 ``ReadArrays``.
- ``ops``      — tensor functions; the Bloom probe, the Bloom build and the
                 correction walk run as hand-written CUDA kernels on CUDA
                 tensors and as plain PyTorch on CPU tensors.
- ``kernels``  — build, ctypes binding and wrappers of ``csrc/kbbq_kernels.cu``.
- ``state``    — conversion of the JAX package's state (as numpy arrays),
                 pass-boundary checkpoints.
- ``pipeline`` — FASTQ -> FASTQ recalibration: resident, and streamed
                 through the windowed engine.

Every entry point takes ``device=None``, which means ``torch.device("cuda")``
and raises without a card; the CPU is used only for ``device="cpu"``.
"""

__version__ = "0.1.0"


def resolve_device(device=None):
    """``None`` -> the CUDA device (raises when there is none); anything
    else -> ``torch.device(device)``."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "kbbq_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)

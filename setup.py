"""Package setup: `pip install -e .` -> `kbbq-tpu` console script.

The native IO codec (kbbq_tpu/io/native) builds lazily via make on first
use; no build step is required here (and no pybind11 — ctypes bindings).
The PyTorch/CUDA port (kbbq_tpu_torch, extra "torch") ships its CUDA source
and its C++ IO codec and builds them at first use (nvcc, g++ with zlib),
also bound with ctypes.
"""

from setuptools import find_packages, setup

setup(
    name="kbbq-tpu",
    version="0.1.0",
    description=("TPU-native reference-free base quality score "
                 "recalibration (kbbq capabilities, JAX/XLA design)"),
    packages=find_packages(include=["kbbq_tpu", "kbbq_tpu.*",
                                    "kbbq_tpu_torch", "kbbq_tpu_torch.*"]),
    package_data={"kbbq_tpu.io": ["native/Makefile", "native/*.cc"],
                  "kbbq_tpu_torch": ["csrc/*.cu", "csrc/*.cc"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
    extras_require={"plot": ["matplotlib"],
                    # the PyTorch/CUDA port (kbbq_tpu_torch); its kernels
                    # build with nvcc at first use
                    "torch": ["torch"]},
    entry_points={
        "console_scripts": ["kbbq-tpu=kbbq_tpu.cli.main:main"],
    },
)

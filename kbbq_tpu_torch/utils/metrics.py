"""Measurement helpers of the port's scripts.

``profile_trace`` is the JAX package's ``kbbq_tpu/utils/metrics.py::
profile_trace`` in PyTorch's idiom: a ``torch.profiler`` trace of the host
and, on a card, of the device, exported as a Chrome trace, in which the
stages and spans of a traced job (``utils/trace.py``) are ``kbbq.<name>``
ranges.  ``smi_line`` reads the card's name and power limit,
``peak_rss_bytes`` the process's peak resident set.
"""

from __future__ import annotations


def smi_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def peak_rss_bytes() -> int | None:
    """This process's peak resident set in bytes (``VmHWM`` of
    ``/proc/self/status``), or None where /proc does not give it.
    ``getrusage``'s ``ru_maxrss`` is no stand-in: in a child it may count
    the resident set its parent had when it forked."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def profile_trace(path: str):
    """Context manager: a ``torch.profiler`` trace of the block it wraps,
    written to `path` as a Chrome trace (``chrome://tracing``, Perfetto).
    It records the host's operators, and the card's kernels too where a
    card is available, on every thread (``profile_all_threads``: the
    ranges of the streamed route's read-ahead and writer threads)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])

    @contextlib.contextmanager
    def cm():
        with profile(activities=activities, experimental_config=
                     _ExperimentalConfig(profile_all_threads=True)) as prof:
            yield prof
        prof.export_chrome_trace(str(path))

    return cm()

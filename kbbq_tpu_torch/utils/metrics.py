"""Throughput metrics + structured logging.

Counterpart of ``kbbq_tpu/utils/metrics.py``: every pass reports wall time
and reads/s through a structured logger that emits either human lines or
JSON records (the same lines and records as the JAX package's).
``profile_trace`` is the same function in PyTorch's idiom: a
``torch.profiler`` trace of the host and, on a card, of the device,
exported as a Chrome trace.  ``peak_rss_bytes`` reads the process's peak
resident set.
"""

from __future__ import annotations

import json
import sys
import time


class Metrics:
    def __init__(self, stream=None, as_json: bool = False):
        self.stream = stream or sys.stderr
        self.as_json = as_json
        self.records: list[dict] = []

    def event(self, name: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "event": name, **fields}
        self.records.append(rec)
        if self.as_json:
            self.stream.write(json.dumps(rec) + "\n")
        else:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            self.stream.write(
                f"[kbbq-tpu {time.strftime('%H:%M:%S')}] {name} {kv}\n")
        self.stream.flush()

    def pass_timer(self, name: str, num_reads: int):
        return _PassTimer(self, name, num_reads)


class _PassTimer:
    def __init__(self, metrics: Metrics, name: str, num_reads: int):
        self.metrics = metrics
        self.name = name
        self.num_reads = num_reads

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.time() - self.t0
        self.metrics.event(
            self.name, wall_s=round(dt, 3),
            reads_per_s=round(self.num_reads / max(dt, 1e-9), 1))
        return False


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
    card is available."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])

    @contextlib.contextmanager
    def cm():
        with profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(str(path))

    return cm()

"""Reduction of the traced window's profiler events to what the per-layer
readers and the result's ``breakdown`` need.

The harness marks each job with a ``bench.job`` range (a host event of
``torch.profiler``); nothing of the program is patched.  Device events
are the card's kernels, copies and sets.  An idle gap of a job is
labelled by where it falls against the job's device work: before its
first device operation (the host reads and decodes the input), before a
device operation inside the passes (the host's glue before that
operation), or after its last (the host renders or rewrites and writes).
A kernel of the program is one whose name is not PyTorch's, CUDA's or a
copy or set: the program's kernels are its own C++ functions, so a kernel
that a later change renames or fuses still counts."""

from __future__ import annotations

from collections import defaultdict

# names of device work that is not a kernel of the program
LIBRARY_MARKS = ("at::", "c10::", "cub::", "thrust::", "cutlass",
                 "Memcpy", "Memset", "memcpy", "memset", "nccl")
JOB = "bench.job"
BEFORE, AFTER = "host_before_device_work", "host_after_device_work"
INSIDE = "host_before "


def is_program_kernel(name: str) -> bool:
    return not any(m in name for m in LIBRARY_MARKS)


def _merge(spans):
    """Overlapping (start, end, name) spans merged -> [start, end, the name
    of the operation that opened the merged span]."""
    out = []
    for s, e, n in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e, n])
    return out


def _device_type_name(ev) -> str:
    return str(getattr(ev, "device_type", "")).rsplit(".", 1)[-1]


def reduce(events) -> dict:
    """From profiler FunctionEvents (times in microseconds on one clock):
    jobs (their count), window_s (the jobs' wall, summed), busy_s (time
    with device work, summed over the jobs), program_kernel_s,
    device_ops (seconds by device operation name, the 10 longest) and
    idle_gaps (idle seconds by label, the 10 longest)."""
    jobs, dev = [], []
    for ev in events:
        name = ev.name
        s, e = ev.time_range.start, ev.time_range.end
        if _device_type_name(ev) == "CUDA":
            if name.startswith("bench.") or getattr(
                    ev, "is_user_annotation", False):
                continue
            dev.append((s, e, name))
        elif name == JOB:
            jobs.append((s, e))
    jobs.sort()
    busy = 0.0
    window = 0.0
    gaps = defaultdict(float)
    for js, je in jobs:
        window += je - js
        spans = _merge([(max(s, js), min(e, je), n) for s, e, n in dev
                        if e > js and s < je])
        busy += sum(e - s for s, e, _ in spans)
        cur = js
        for i, (s, e, n) in enumerate(spans):
            if s > cur:
                gaps[BEFORE if i == 0 else INSIDE + n[:80]] += s - cur
            cur = max(cur, e)
        if je > cur:
            gaps[AFTER if spans else BEFORE] += je - cur
    ops = defaultdict(float)
    kernel = 0.0
    for s, e, name in dev:
        ops[name[:160]] += e - s
        if is_program_kernel(name):
            kernel += e - s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"jobs": len(jobs), "window_s": window * 1e-6,
            "busy_s": busy * 1e-6, "program_kernel_s": kernel * 1e-6,
            "device_events": len(dev),
            "device_ops": [[n, v * 1e-6] for n, v in top],
            "idle_gaps": [[n, v * 1e-6] for n, v in top_gaps]}

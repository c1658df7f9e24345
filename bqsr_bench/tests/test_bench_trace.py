"""The traced window's reduction: busy and idle time of each job, the
program's kernels told from PyTorch's and from copies, and each idle gap
labelled by where it falls against the job's device work."""

from types import SimpleNamespace

import pytest

from bqsr_bench.harness import trace


def _ev(name, start, end, device="CUDA"):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                           time_range=SimpleNamespace(start=start, end=end))


def test_a_job_is_reduced_to_busy_kernel_and_labelled_idle_time():
    events = [
        _ev(trace.JOB, 0, 1000, device="CPU"),
        _ev("Memcpy HtoD (Pageable -> Device)", 300, 400),
        _ev("hash_build_kernel<0, 7>", 420, 470),
        _ev("void at::native::reduce_kernel", 460, 480),
        _ev("walk_resolve_kernel", 600, 650),
        _ev("Memcpy DtoH (Device -> Pageable)", 700, 750),
        _ev("walk_resolve_kernel", 1200, 1300),     # after the job
    ]
    r = trace.reduce(events)
    assert r["jobs"] == 1
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((100 + 60 + 50 + 50) * 1e-6)
    assert r["program_kernel_s"] == pytest.approx((50 + 50 + 100) * 1e-6)
    gaps = dict(r["idle_gaps"])
    assert gaps == pytest.approx({
        trace.BEFORE: 300e-6,
        trace.INSIDE + "hash_build_kernel<0, 7>": 20e-6,
        trace.INSIDE + "walk_resolve_kernel": 120e-6,
        trace.INSIDE + "Memcpy DtoH (Device -> Pageable)": 50e-6,
        trace.AFTER: 250e-6})
    assert sum(gaps.values()) + r["busy_s"] == pytest.approx(r["window_s"])


def test_a_job_with_no_device_work_is_idle_throughout():
    r = trace.reduce([_ev(trace.JOB, 0, 500, device="CPU")])
    assert r["busy_s"] == 0 and r["device_events"] == 0
    assert dict(r["idle_gaps"]) == pytest.approx({trace.BEFORE: 500e-6})

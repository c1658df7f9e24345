"""The readers of the program's spans and counters (``harness/spans.py``
and the metrics that use it) on synthetic runs, with nothing to read where
the program has no spans or counters, or its copies no device time."""

import pytest

from bqsr_bench.harness import spec


def span(name, start, end, device_s=None):
    r = {"id": 0, "name": name, "start": start, "end": end, "thread": 1,
         "parent": None}
    if device_s is not None:
        r["device_s"] = device_s
    return r


def job():
    """One traced job's timings as the program writes them."""
    return {
        "spans": [
            span("fastq.load", 0.0, 0.1), span("fastq.index", 0.1, 0.3),
            span("h2d.copy", 1.0, 1.2, device_s=0.05),
            span("h2d.copy", 1.3, 1.4, device_s=0.05),
            span("d2h.copy", 2.0, 2.1, device_s=0.02),
            span("fastq.render", 2.5, 2.9),
        ],
        "counters": {"fastq.in_bytes": 400e6, "h2d_bytes": 3e9,
                     "d2h_bytes": 4e8},
    }


# each reader's value on two jobs of `job()`, the same as on one
WANT = {
    "h2d_gb_per_s": 3e9 / 0.1 / 1e9,
    "d2h_gb_per_s": 4e8 / 0.02 / 1e9,
}
# what each reader needs: its counter and its span
NEEDS = {
    "h2d_gb_per_s": ("h2d_bytes", "h2d.copy"),
    "d2h_gb_per_s": ("d2h_bytes", "d2h.copy"),
}


def run_of(*timings):
    return {"jobs": [{"start": 0, "end": 1, "failed": False, "timings": t}
                     for t in timings]}


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_reads_the_spans_and_counters(name):
    read = spec.reader(name)
    assert read(run_of(job(), job())) == pytest.approx(WANT[name])
    # a job of twice the bytes in twice the time: the same rate
    two = job()
    for r in two["spans"]:
        r["start"], r["end"] = 2 * r["start"], 2 * r["end"]
        if "device_s" in r:
            r["device_s"] *= 2
    two["counters"] = {k: 2 * v for k, v in two["counters"].items()}
    assert read(run_of(job(), two)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_finds_nothing_without_its_spans_or_counters(name):
    read = spec.reader(name)
    counter, needed = NEEDS[name]
    assert read(run_of()) is None
    # a program older than its tracer: stage seconds, no spans
    assert read(run_of({"read": 1.0, "write": 2.0})) is None
    no_span = job()
    no_span["spans"] = [r for r in no_span["spans"] if r["name"] != needed]
    assert read(run_of(job(), no_span)) is None
    no_count = job()
    del no_count["counters"][counter]
    assert read(run_of(no_count)) is None
    # host spans only, as on the CPU, where there are no CUDA events
    host = job()
    for r in host["spans"]:
        r.pop("device_s", None)
    assert read(run_of(host)) is None

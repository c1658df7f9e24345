"""The program's own spans and counters, as the per-layer readers take
them from a traced run.

A traced job's ``timings`` (the dict the harness hands the entry point)
holds, where the program records them, ``spans``: one record per stage or
span, ``{"name", "start", "end", ...}`` in seconds, with ``device_s``, the
time between its CUDA events, on a span of device work; and ``counters``:
name -> count.  A program without them, such as one older than its
tracer, leaves every reader here with nothing to read (None), and so
does a run without a card, whose spans have no device seconds."""

from __future__ import annotations


def device_seconds(timings: dict, name: str):
    """The device seconds of one job's spans `name`, summed; None where
    it has no such span or one has no device seconds."""
    found = [r for r in timings.get("spans") or () if r.get("name") == name]
    if not found or any("device_s" not in r for r in found):
        return None
    return sum(r["device_s"] for r in found)


def device_rate(run, counter: str, name: str, unit: float):
    """The window's sum of `counter` over its sum of the device seconds
    of the spans `name`, in units of `unit` a second; None where a traced
    job lacks the counter or the spans' device seconds."""
    jobs = [j["timings"] for j in run["jobs"] if j.get("timings")]
    if not jobs:
        return None
    count = secs = 0.0
    for t in jobs:
        c = (t.get("counters") or {}).get(counter)
        s = device_seconds(t, name)
        if c is None or s is None:
            return None
        count += c
        secs += s
    return count / secs / unit if secs > 0 else None

"""The largest rise of the process's resident set over the window's first
job above its resident set at the job's start (sampled every millisecond
by a child process, ``harness/memory.py``, through that job only, so that
no sampler runs beside the later jobs whose rate ``reads_per_s`` reads)."""


def read(run):
    peaks = [j["peak_host_bytes"] for j in run["jobs"]
             if "peak_host_bytes" in j]
    return max(peaks) if peaks else None

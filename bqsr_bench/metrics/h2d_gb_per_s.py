"""GB/s of the copies to the card: the bytes the program counts
(``h2d_bytes``) over the card's time between the CUDA events of its
``h2d.copy`` spans, summed over the window's jobs."""

from bqsr_bench.harness import spans


def read(run):
    return spans.device_rate(run, "h2d_bytes", "h2d.copy", 1e9)

"""GB/s of the copies from the card: the bytes the program counts
(``d2h_bytes``) over the card's time between the CUDA events of its
``d2h.copy`` spans (pass 3's tables, pass 4's new qualities), summed over
the window's jobs."""

from bqsr_bench.harness import spans


def read(run):
    return spans.device_rate(run, "d2h_bytes", "d2h.copy", 1e9)

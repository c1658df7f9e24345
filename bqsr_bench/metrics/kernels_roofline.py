"""Share of the least time the passes need on the card (the yardstick in
``harness/roofline.py``, from the reference's counts of this sample) in the
device time of the program's kernels, summed over the window's jobs."""

from bqsr_bench.harness import roofline


def read(run):
    tr = run["trace"]
    if not tr or tr["program_kernel_s"] <= 0 or not run["jobs"]:
        return None
    least = sum(roofline.passes_least_s(run["counts"]).values())
    return 100.0 * least * len(run["jobs"]) / tr["program_kernel_s"]

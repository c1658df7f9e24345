"""Milliseconds a job of the program's own kernels on the card, from the
profiler's device events, summed over the window's jobs and divided by
their count."""


def read(run):
    tr = run["trace"]
    if not tr or tr["program_kernel_s"] <= 0 or not run["jobs"]:
        return None
    return tr["program_kernel_s"] * 1e3 / len(run["jobs"])

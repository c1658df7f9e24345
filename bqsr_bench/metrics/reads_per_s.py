"""Reads recalibrated a second: the records of every job completed in the
window over the time from the window's start to the last job's end."""


def read(run):
    jobs = run["jobs"]
    if not jobs:
        return None
    return len(jobs) * run["records_per_job"] / run["window_s"]

"""Seconds a job of the resident passes: the program's stage clock from
its set-up to pass 4 (each stage closed by a device synchronise), summed
over the window's jobs and divided by their count."""

STAGES = ("setup", "h2d", "pass1", "pass2", "pass3", "deltas", "pass4")


def read(run):
    t = [j["timings"] for j in run["jobs"] if j["timings"]]
    if not t or not all(s in x for x in t for s in STAGES):
        return None
    return sum(x[s] for x in t for s in STAGES) / len(t)

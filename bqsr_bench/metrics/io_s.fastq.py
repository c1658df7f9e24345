"""Seconds a job of the FASTQ codec: the entry point's ``read`` (read and
decode) and ``write`` (render and write) stages, summed over the window's
jobs and divided by their count."""

STAGES = ("read", "write")


def read(run):
    if run["config"]["format"] != "fastq":
        return None
    t = [j["timings"] for j in run["jobs"] if j["timings"]]
    if not t or not all(s in x for x in t for s in STAGES):
        return None
    return sum(x[s] for x in t for s in STAGES) / len(t)

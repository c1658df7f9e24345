"""Seconds a job of the BAM codec: the entry point's ``read`` (inflate),
``decode``, ``rewrite`` and ``write`` (deflate) stages, summed over the
window's jobs and divided by their count."""

STAGES = ("read", "decode", "rewrite", "write")


def read(run):
    if run["config"]["format"] != "bam":
        return None
    t = [j["timings"] for j in run["jobs"] if j["timings"]]
    if not t or not all(s in x for x in t for s in STAGES):
        return None
    return sum(x[s] for x in t for s in STAGES) / len(t)

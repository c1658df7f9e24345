"""`kbbq-tpu plot`: calibration curves from benchmark TSV.

Counterpart of ``kbbq_tpu/plot.py`` (the same figure): panel 1 is
reported-vs-actual quality with the y=x diagonal; panel 2 is the sample
size per reported Q.  matplotlib (the ``plot`` extra) is imported only
when a figure is drawn.
"""

from __future__ import annotations


def plot_benchmark(tsv_path: str, out_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series: dict[str, dict] = {}
    with open(tsv_path) as f:
        header = f.readline()
        if not header.startswith("label"):
            raise ValueError("not a kbbq benchmark TSV")
        for line in f:
            label, rq, aq, n = line.rstrip("\n").split("\t")
            s = series.setdefault(label, {"rq": [], "aq": [], "n": []})
            s["rq"].append(int(rq))
            s["aq"].append(float(aq))
            s["n"].append(int(n))

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(7, 9), sharex=True,
                                   height_ratios=[3, 1])
    maxq = 1
    for label, s in series.items():
        ax1.plot(s["rq"], s["aq"], marker="o", ms=3, lw=1, label=label)
        ax2.bar(s["rq"], s["n"], alpha=0.6, label=label)
        maxq = max([maxq] + s["rq"] + [int(max(s["aq"], default=1))])
    ax1.plot([0, maxq], [0, maxq], "k--", lw=1, label="perfect calibration")
    ax1.set_ylabel("actual quality (Phred)")
    ax1.legend()
    ax1.grid(alpha=0.3)
    ax2.set_xlabel("reported quality (Phred)")
    ax2.set_ylabel("bases")
    ax2.set_yscale("log")
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)

"""GATKReport recalibration-table interop.

The port's own copy of ``kbbq_tpu/gatk_report.py`` (NumPy and the standard
library only, so the two packages write byte-identical reports): read and
write GATK `BaseRecalibrator`-style reports (RecalTable0/1/2) and turn a
parsed report into the dense Q' lookup table that pass 4 gathers from, as
ApplyBQSR would apply it.

Format notes (GATKReport v1.1): '#:GATKReport.v1.1:<ntables>' header;
each table is '#:GATKTable:<ncols>:<nrows>:<fmt...>:;' + a
'#:GATKTable:<name>:<description>' line + whitespace-aligned columns.
EventType 'M' (mismatch) is the only event kbbq models.  Context
covariates are 2-mers (our dinucleotide), cycles are signed ints.
"""

from __future__ import annotations

import numpy as np

from .constants import (
    MAX_Q,
    NUM_DINUC,
    NUM_Q,
    RECAL_MIN_Q,
    cycle_to_index,
)
from .oracle.covariate import CovariateTables
from .oracle.gatk import compute_deltas, empirical_quality

_BASES = "ACGT"


def _dinuc_str(d: int) -> str:
    return _BASES[d // 4] + _BASES[d % 4]


def _dinuc_index(s: str) -> int:
    return _BASES.index(s[0]) * 4 + _BASES.index(s[1])


def _cycle_value(idx: int) -> int:
    """Table index -> signed cycle (inverse of constants.cycle_to_index)."""
    mag = idx // 2 + 1
    return -mag if idx % 2 else mag


def _rg_label(name: str) -> str:
    """Report-safe read-group label: the report's columns are
    whitespace-split, so an empty RG (reads without an RG tag) gets a
    sentinel and whitespace is %-escaped — INJECTIVELY ('rg 1' and
    'rg_1' must stay distinct keys), applied identically on write and
    apply."""
    if not name:
        return "__unnamed__"
    out = name.replace("%", "%25")
    for ch, esc in ((" ", "%20"), ("\t", "%09"), ("\n", "%0A"),
                    ("\r", "%0D"), ("\x0b", "%0B"), ("\x0c", "%0C")):
        out = out.replace(ch, esc)
    return out


def write_gatk_report(tables: CovariateTables, rg_names: list[str],
                      path_or_file) -> None:
    """Emit RecalTable0/1/2 in GATKReport v1.1 layout."""
    rg_names = [_rg_label(n) for n in rg_names]
    d = compute_deltas(tables)
    qt, qe = tables.q_total(), tables.q_errors()
    rgt, rge = tables.rg_total(), tables.rg_errors()

    lines: list[str] = []

    def table(name, desc, header, rows):
        lines.append(f"#:GATKTable:{len(header)}:{len(rows)}:"
                     + ":".join(["%s"] * len(header)) + ":;")
        lines.append(f"#:GATKTable:{name}:{desc}")
        widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
                  if rows else len(str(h))
                  for i, h in enumerate(header)]
        lines.append("  ".join(str(h).ljust(w)
                               for h, w in zip(header, widths)).rstrip())
        for r in rows:
            lines.append("  ".join(str(v).ljust(w)
                                   for v, w in zip(r, widths)).rstrip())
        lines.append("")

    rows0 = []
    for rg in range(tables.num_rg):
        if rgt[rg] == 0:
            continue
        emp = empirical_quality(np.array([rge[rg]]), np.array([rgt[rg]]),
                                np.array([d["mean_q"][rg]]))[0]
        rows0.append((rg_names[rg], "M", f"{emp:.4f}",
                      f"{d['mean_q'][rg]:.4f}",
                      int(rgt[rg]), int(rge[rg])))
    table("RecalTable0", "Quality scores by read group",
          ("ReadGroup", "EventType", "EmpiricalQuality",
           "EstimatedQReported", "Observations", "Errors"), rows0)

    rows1 = []
    for rg in range(tables.num_rg):
        for q in range(NUM_Q):
            if qt[rg, q] == 0:
                continue
            emp = empirical_quality(np.array([qe[rg, q]]),
                                    np.array([qt[rg, q]]),
                                    np.array([q + d["delta_rg"][rg]]))[0]
            rows1.append((rg_names[rg], q, "M", f"{emp:.4f}",
                          int(qt[rg, q]), int(qe[rg, q])))
    table("RecalTable1", "Quality scores by read group and quality score",
          ("ReadGroup", "QualityScore", "EventType", "EmpiricalQuality",
           "Observations", "Errors"), rows1)

    rows2 = []
    for rg in range(tables.num_rg):
        for q in range(NUM_Q):
            prior = (q + d["delta_rg"][rg] + d["delta_q"][rg, q])
            for c in range(tables.cyc_total.shape[2]):
                n = tables.cyc_total[rg, q, c]
                if n == 0:
                    continue
                e = tables.cyc_errors[rg, q, c]
                emp = empirical_quality(np.array([e]), np.array([n]),
                                        np.array([prior]))[0]
                rows2.append((rg_names[rg], q, str(_cycle_value(c)),
                              "Cycle", "M", f"{emp:.4f}", int(n), int(e)))
            for dn in range(NUM_DINUC):
                n = tables.din_total[rg, q, dn]
                if n == 0:
                    continue
                e = tables.din_errors[rg, q, dn]
                emp = empirical_quality(np.array([e]), np.array([n]),
                                        np.array([prior]))[0]
                rows2.append((rg_names[rg], q, _dinuc_str(dn), "Context",
                              "M", f"{emp:.4f}", int(n), int(e)))
    table("RecalTable2",
          "Quality scores by read group, quality score, and covariate",
          ("ReadGroup", "QualityScore", "CovariateValue", "CovariateName",
           "EventType", "EmpiricalQuality", "Observations", "Errors"),
          rows2)

    text = "#:GATKReport.v1.1:3\n" + "\n".join(lines)
    if isinstance(path_or_file, str):
        with open(path_or_file, "w") as f:
            f.write(text)
    else:
        path_or_file.write(text)


def read_gatk_report(path: str) -> dict:
    """Parse a GATKReport into {table_name: list-of-dict-rows}."""
    tables: dict[str, list] = {}
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("#:GATKTable:") and ln.endswith(";"):
            name_line = lines[i + 1]
            name = name_line.split(":")[2]
            header = lines[i + 2].split()
            rows = []
            j = i + 3
            while j < len(lines) and lines[j].strip():
                vals = lines[j].split()
                if len(vals) == len(header):
                    rows.append(dict(zip(header, vals)))
                j += 1
            tables[name] = rows
            i = j
        else:
            i += 1
    return tables


def recal_table_from_report(report: dict, rg_names: list[str],
                            max_len: int) -> np.ndarray:
    """ApplyBQSR math from a parsed report -> dense int8 Q' lookup
    [num_rg, NUM_Q, 2*max_len, 17] (the same table the device gather uses).

    q' = clamp(round(q + dRG + dQ + dCycle + dContext)) with each delta =
    EmpiricalQuality(level) - prior(level), empty cells contributing 0 —
    the standard GATK hierarchy (DECISIONS.md D9/D10).
    """
    num_rg = len(rg_names)
    rg_idx = {_rg_label(n): i for i, n in enumerate(rg_names)}
    nc = 2 * max_len

    d_rg = np.zeros(num_rg)
    est_q = np.zeros(num_rg)
    for row in report.get("RecalTable0", []):
        if row["EventType"] != "M" or row["ReadGroup"] not in rg_idx:
            continue
        rg = rg_idx[row["ReadGroup"]]
        est_q[rg] = float(row["EstimatedQReported"])
        d_rg[rg] = float(row["EmpiricalQuality"]) - est_q[rg]

    d_q = np.zeros((num_rg, NUM_Q))
    for row in report.get("RecalTable1", []):
        if row["EventType"] != "M" or row["ReadGroup"] not in rg_idx:
            continue
        rg = rg_idx[row["ReadGroup"]]
        q = int(row["QualityScore"])
        d_q[rg, q] = float(row["EmpiricalQuality"]) - (q + d_rg[rg])

    d_cyc = np.zeros((num_rg, NUM_Q, nc))
    d_din = np.zeros((num_rg, NUM_Q, NUM_DINUC))
    for row in report.get("RecalTable2", []):
        if row["EventType"] != "M" or row["ReadGroup"] not in rg_idx:
            continue
        rg = rg_idx[row["ReadGroup"]]
        q = int(row["QualityScore"])
        prior = q + d_rg[rg] + d_q[rg, q]
        delta = float(row["EmpiricalQuality"]) - prior
        if row["CovariateName"] == "Cycle":
            c = cycle_to_index(int(row["CovariateValue"]))
            if 0 <= c < nc:
                d_cyc[rg, q, c] = delta
        elif row["CovariateName"] == "Context":
            d_din[rg, q, _dinuc_index(row["CovariateValue"])] = delta

    q = np.arange(NUM_Q, dtype=np.float64)
    base = q[None, :] + d_rg[:, None] + d_q
    din = np.concatenate([d_din, np.zeros((num_rg, NUM_Q, 1))], axis=2)
    out = (base[:, :, None, None] + d_cyc[:, :, :, None]
           + din[:, :, None, :])
    return np.clip(np.round(out), RECAL_MIN_Q, MAX_Q).astype(np.int8)

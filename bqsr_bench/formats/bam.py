"""Input format ``bam``: a coordinate-sorted BGZF BAM with three read
groups (``cfg["bam"]["extra_share"]`` of the reads followed by a secondary
or supplementary copy).  Written and judged as ``fastq.py`` describes; the
reference takes the primary records in file order, and with
``entry_kwargs.set_oq`` the output carries OQ tags."""

import os

from bqsr_bench.harness import synth
from bqsr_bench.reference.outputs import BamExpected


def write(tmpdir: str, reads: dict, cfg: dict):
    path = os.path.join(tmpdir, "sample.bam")
    lay = synth.write_bam(path, reads, cfg["bam"]["extra_share"])
    return path, synth.decode_order(reads, lay), lay, int(lay["src"].size)


def expected(reads: dict, layout, new_quals, cfg: dict):
    return BamExpected(reads, layout, new_quals,
                       bool(cfg.get("entry_kwargs", {}).get("set_oq")))

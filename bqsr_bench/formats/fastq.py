"""Input format ``fastq``: one plain-text interleaved FASTQ.

A format file gives ``write(tmpdir, reads, cfg)``, which writes the
sample's input file and returns (its path, the reads in the order the
program decodes them as the reference takes them, the layout that
``expected`` needs, the records a job recalibrates), and
``expected(reads, layout, new_quals, cfg)``, the output a recalibration
must write (an object with ``judge(bytes)`` and ``as_written()``)."""

import os

import numpy as np

from bqsr_bench.harness import synth
from bqsr_bench.reference.outputs import FastqExpected


def write(tmpdir: str, reads: dict, cfg: dict):
    path = os.path.join(tmpdir, "sample.fq")
    synth.write_fastq(path, reads)
    n = reads["codes"].shape[0]
    ref_in = {"codes": reads["codes"], "quals": reads["quals"],
              "seconds": reads["seconds"],
              "rgs": np.zeros(n, np.int64), "num_rg": 1}
    return path, ref_in, None, n


def expected(reads: dict, layout, new_quals, cfg: dict):
    return FastqExpected(reads, new_quals)

"""Small cells for the CPU tests: the manifest's cells with their samples
cut to a few thousand reads."""

import copy
import time

from bqsr_bench.harness import runner, spec

FASTQ = "ecoli-50x-fastq.resident"
BAM = "ecoli-50x-bam.whole-file"


def small_cell(name: str, num_reads: int = 1500, genome_len: int = 4000):
    cell = copy.deepcopy(spec.cell(name))
    cell["config"]["sample"].update(genome_len=genome_len,
                                    num_reads=num_reads)
    return cell


def cpu_run(name: str, seed: int = 7, traced: bool = False, entry=None,
            cell=None, **kw):
    """A run of the small cell on the CPU -> (result, stdout, stderr)."""
    import io
    out, err = io.StringIO(), io.StringIO()
    res = runner.run(name, seed, 0.2, traced, time.perf_counter(),
                     device="cpu", entry=entry, cell=cell or small_cell(name,
                                                                       **kw),
                     out=out, err=err)
    return res, out.getvalue(), err.getvalue()

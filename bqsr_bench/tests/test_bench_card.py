"""On the card: a short run of each cell is correct, and the check tells
the program from its controls at the cell's own size.  Run with

    python -m pytest bqsr_bench/tests -m card -q
"""

import json
import subprocess
import sys

import pytest

from bqsr_bench.harness import runner, spec
from bqsr_bench.tests.helpers import BAM, FASTQ


@pytest.mark.card
@pytest.mark.parametrize("name", [FASTQ, BAM])
def test_a_short_run_of_the_cell_is_correct(card, name):
    proc = subprocess.run(
        [sys.executable, "bqsr_bench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], proc.stderr[-4000:]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("name", [FASTQ, BAM])
def test_the_controls_fail_where_the_program_passes(card, name):
    r = runner.control_readings(spec.cell(name), 2147483660)
    assert r["program"] == {"qual_bytes_wrong": 0, "other_bytes_wrong": 0}
    assert r["half_filters"]["qual_bytes_wrong"] > 0

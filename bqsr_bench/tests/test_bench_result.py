"""The result line: its keys, the metrics of each kind of run, and the
compared numbers printed last on standard error; without a CUDA card the
command exits non-zero and prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bqsr_bench.harness import spec
from bqsr_bench.tests.helpers import BAM, FASTQ, cpu_run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_has_exactly_the_drivers_keys(traced):
    res, out, err = cpu_run(FASTQ, traced=traced, num_reads=400)
    line = json.loads(out.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == want
    assert line == res
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    tail = err.strip().splitlines()[-2:]
    assert tail == [f"[check] {n} {c['value']} limit {c['limit']}"
                    for n, c in line["checks"].items()]


@pytest.mark.parametrize("name,traced,present", [
    (FASTQ, False, {"reads_per_s", "peak_host_bytes", "setup_s"}),
    (BAM, False, {"reads_per_s", "peak_host_bytes", "setup_s"}),
    (FASTQ, True, {"io_s.fastq", "passes_s"}),
    (BAM, True, {"io_s.bam", "passes_s"}),
])
def test_the_metrics_of_each_run_are_the_manifests(name, traced, present):
    # on the CPU the device readings have nothing to read and stay out
    res, out, err = cpu_run(name, traced=traced, num_reads=400)
    cell = spec.cell(name)
    names = {m["name"] for m in cell["per_layer" if traced else
                                     "end_to_end"]}
    assert set(res["metrics"]) == present <= names
    for m in cell["per_layer" if traced else "end_to_end"]:
        if m["name"] in res["metrics"]:
            assert res["metrics"][m["name"]]["unit"] == m["unit"]


def _run_command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bqsr_bench/run.py", "--workload", FASTQ, "--seed",
         "3", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_without_a_card_the_command_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_command(spec.ROOT, env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_benchmark_alone_cannot_run(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bqsr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_command(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""

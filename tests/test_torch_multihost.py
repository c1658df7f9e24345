"""Several hosts in the port (kbbq_tpu_torch/parallel/multihost.py), FASTQ:
the partition helpers held against the JAX package's on the same inputs,
then two host processes over gloo through the command line (``main(argv,
device="cpu")`` in each, ``tests/_host_cases.py``), each host's ranks in
one group with the other's.  Every output must be the JAX package's
single-host ``recalibrate_fastq`` bytes: both filter layouts, a report
round trip, a host killed between pass 1 and pass 2 and the run resumed
(pass 1 not rewritten), pass 4 resumed from a host's progress file, a host
with no file, and two ranks on each host.  BAM and CRAM are in
tests/test_torch_multihost_cram.py.  Tolerance: exact equality.
"""

import json
import os

import numpy as np
import pytest

from kbbq_tpu.parallel import multihost as jmh
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline import recalibrate_fastq as j_recalibrate_fastq

from kbbq_tpu_torch.parallel import multihost as tmh
from kbbq_tpu_torch.utils.synth import make_dataset, to_fastq_bytes

from _host_cases import crash_and_stop, run_hosts

CFG = dict(k=16, coverage=20.0, batch_size=64)
ARGS = ["-k", "16", "-c", "20.0", "--batch-size", "64", "--chunk-reads",
        "60", "--multihost"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """tests/test_multihost_driver.py's three FASTQ files (one a read
    group) and the JAX package's single-host outputs and report."""
    d = tmp_path_factory.mktemp("mh_inputs")
    paths, want = [], []
    for i, (gl, rl, seed) in enumerate(
            [(900, 55, 61), (400, 48, 62), (1400, 60, 63)]):
        ds = make_dataset(genome_len=gl, read_len=rl, coverage=15.0,
                          error_rate=0.02, seed=seed)
        p = d / f"in{i}.fq"
        p.write_bytes(to_fastq_bytes(ds))
        paths.append(str(p))
        want.append(str(d / f"want{i}.fq"))
    report = str(d / "want.report")
    j_recalibrate_fastq(paths, want, JRecalConfig(**CFG), report_out=report)
    return {"paths": paths, "want": [open(w, "rb").read() for w in want],
            "report": report}


def _outs(d, n=3):
    return [str(d / f"out{i}.fq") for i in range(n)]


def _argv(paths, outs, *flags):
    argv = ["recalibrate", *paths, *ARGS, *flags]
    for o in outs:
        argv += ["-o", o]
    return argv


def _same(outs, want):
    for i, (o, w) in enumerate(zip(outs, want)):
        with open(o, "rb") as f:
            assert f.read() == w, f"output {i} differs"


# ------------------------------------------------------------- helpers

@pytest.mark.parametrize("counts", [
    [100, 50, 200, 10, 40], [1000, 900, 500, 400, 300, 250, 240, 200, 120,
                             90], [5, 5, 5], [0, 7, 0, 7], [3]])
@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
def test_partition_inputs_is_the_references(counts, hosts):
    """The same LPT assignment, ordinals, read groups and counts as the JAX
    package's, host by host (a host may get no file)."""
    paths = [f"f{i}.fq" for i in range(len(counts))]
    for h in range(hosts):
        got = tmh.partition_inputs(paths, counts, h, hosts)
        ref = jmh.partition_inputs(paths, counts, h, hosts)
        assert (got.paths, got.start_ordinal, got.rg_ids, got.read_counts,
                got.total_reads) == (ref.paths, ref.start_ordinal,
                                     ref.rg_ids, ref.read_counts,
                                     ref.total_reads)


def test_host_steps_and_chunk_ranges_are_the_references():
    """host_steps_per_pass and partition_bam_chunks on the reference's
    cases and on random ones."""
    rng = np.random.default_rng(5)
    cases = [([[100, 50], [120]], 64), ([[], [64]], 64), ([], 64)]
    cases += [([list(rng.integers(0, 300, rng.integers(0, 5)))
                for _ in range(rng.integers(1, 5))], int(rng.integers(1, 90)))
              for _ in range(40)]
    for counts, batch in cases:
        assert tmh.host_steps_per_pass(counts, batch) == \
            jmh.host_steps_per_pass(counts, batch)
    metas = [{"n_primary": c} for c in (100, 100, 50, 200, 80, 70, 90)]
    for hosts in (1, 2, 3, 7, 9):
        assert tmh.partition_bam_chunks(metas, hosts) == \
            jmh.partition_bam_chunks(metas, hosts)
    for _ in range(40):
        metas = [{"n_primary": int(c)}
                 for c in rng.integers(0, 50, rng.integers(0, 12))]
        hosts = int(rng.integers(1, 6))
        assert tmh.partition_bam_chunks(metas, hosts) == \
            jmh.partition_bam_chunks(metas, hosts)


def test_init_multihost_reads_the_launchers_variables(monkeypatch):
    """The JAX package's three variables, arguments first; one process
    needs no coordinator, several do; a process id out of range is
    refused."""
    for name in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert tmh.init_multihost() == {"process_id": 0, "num_processes": 1,
                                    "coordinator": None}
    monkeypatch.setenv("JAX_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    assert tmh.init_multihost() == {"process_id": 3, "num_processes": 4,
                                    "coordinator": "10.0.0.1:1234"}
    assert tmh.init_multihost(process_id=1)["process_id"] == 1
    with pytest.raises(ValueError, match="process id 4"):
        tmh.init_multihost(process_id=4)
    monkeypatch.delenv("JAX_COORDINATOR")
    with pytest.raises(ValueError, match="JAX_COORDINATOR"):
        tmh.init_multihost()


def test_refusals_before_any_rank_starts(inputs, tmp_path, monkeypatch):
    """The reference's refusals on the command line (SAM, two BAM or CRAM
    inputs, --set-oq with CRAM, not one -o per FASTQ input), parts named
    for another format (the single host's windowed routes' rule), and a
    sharded group that is not a power of two (3 hosts), before any rank
    starts."""
    from kbbq_tpu_torch.cli.main import main
    p = inputs["paths"]
    for argv, msg in (
            (["x.sam", "-o", "y.bam"], "convert SAM"),
            (["a.bam", "b.bam", "-o", "y.bam"], "one input"),
            (["a.cram", "b.cram", "-o", "y.cram"], "one input"),
            (["a.cram", "-o", "y.cram", "--set-oq"], "--set-oq"),
            ([*p, "-o", "one.fq"], "one -o output per input")):
        with pytest.raises(SystemExit) as e:
            main(["recalibrate", *argv, "--multihost"], device="cpu")
        assert msg in str(e.value.code)
    for argv in (["a.bam", "-o", "y.sam"], ["a.bam", "-o", "y.cram"],
                 ["a.cram", "-o", "y.bam"]):          # the parts' format
        assert main(["recalibrate", *argv, "--multihost"], device="cpu") == 1
    monkeypatch.setenv("JAX_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    outs = _outs(tmp_path)
    assert main(_argv(p, outs, "--bloom-layout", "sharded"),
                device="cpu") == 1
    assert not any(os.path.exists(o) for o in outs)


# ------------------------------------------------- two host processes

@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_two_hosts_write_the_single_hosts_bytes(inputs, tmp_path, layout):
    """Two hosts over gloo, each its LPT share of the files: every output
    the JAX package's single-host bytes; the hosts' reads add up."""
    outs = _outs(tmp_path)
    stats = run_hosts(_argv(inputs["paths"], outs, "--bloom-layout",
                            layout), tmp_path)
    _same(outs, inputs["want"])
    assert sum(s["host_reads_written"] for s in stats) == \
        stats[0]["num_reads"]
    assert [s["devices"] for s in stats] == [2, 2]
    assert {s["bloom_layout"] for s in stats} == {layout}
    assert [s["timings"]["world"] for s in stats] == [2, 2]
    if layout == "sharded":
        assert all(s["timings"]["walk_rounds"] > 0 for s in stats)


def test_two_hosts_report_round_trip(inputs, tmp_path):
    """applybqsr from the single host's report on two hosts gives its
    bytes (no collective runs); --report-out on two hosts writes the single
    host's report, from host 0."""
    outs = _outs(tmp_path)
    argv = ["applybqsr", "-r", inputs["report"], *inputs["paths"], *ARGS]
    for o in outs:
        argv += ["-o", o]
    run_hosts(argv, tmp_path)
    _same(outs, inputs["want"])
    report = tmp_path / "two.report"
    (tmp_path / "x").mkdir()
    outs2 = _outs(tmp_path / "x")
    run_hosts(_argv(inputs["paths"], outs2, "--report-out", str(report)),
              tmp_path)
    _same(outs2, inputs["want"])
    assert report.read_text() == open(inputs["report"]).read()


def _marked(ck, name):
    def done():
        try:
            with open(os.path.join(ck, "meta.json")) as f:
                return name in json.load(f)["passes_done"]
        except (OSError, ValueError):
            return False
    return done


@pytest.mark.parametrize("layout,files", [
    ("replicated", ["mh_rows_a.npy"]),
    ("sharded", ["mh_sh_rows_a_host0.npy", "mh_sh_rows_a_host1.npy"])])
def test_a_killed_host_resumes_from_pass_1(inputs, tmp_path, layout, files):
    """Host 1 killed between pass 1 and pass 2 (exit 41), host 0 killed
    waiting on it; the rerun loads pass 1 (its files not rewritten) and
    writes the single host's bytes."""
    ck = str(tmp_path / "ck")
    outs = _outs(tmp_path)
    argv = _argv(inputs["paths"], outs, "--bloom-layout", layout,
                 "--checkpoint-dir", ck)
    name = files[0].split("_host")[0].removesuffix(".npy")
    crash_and_stop(argv, tmp_path, _marked(ck, name))
    paths = [os.path.join(ck, f) for f in files]
    mtimes = [os.path.getmtime(p) for p in paths]
    meta = json.load(open(os.path.join(ck, "meta.json")))
    assert meta["passes_done"] == [name]
    assert meta["fingerprint"]["num_processes"] == 2
    assert meta["fingerprint"]["bloom_layout"] == layout
    run_hosts(argv, tmp_path)
    _same(outs, inputs["want"])
    assert [os.path.getmtime(p) for p in paths] == mtimes
    assert sorted(json.load(open(os.path.join(ck, "meta.json")))
                  ["passes_done"]) == sorted([name, name[:-1] + "b",
                                              "covariates"])


def test_pass_4_resumes_from_a_hosts_progress(inputs, tmp_path, capsys,
                                              monkeypatch):
    """A finished checkpointed run, then host 1's output cut back to its
    first chunk and its progress file set there: the rerun runs no pass
    (no saved file rewritten), continues that file from the byte recorded,
    and the bytes are the single host's; one host on the same checkpoint is
    refused by the fingerprint's process count."""
    ck = str(tmp_path / "ck")
    outs = _outs(tmp_path)
    argv = _argv(inputs["paths"], outs, "--checkpoint-dir", ck)
    run_hosts(argv, tmp_path)
    _same(outs, inputs["want"])
    saved = [os.path.join(ck, f) for f in os.listdir(ck)
             if f.endswith(".npy")]
    mtimes = [os.path.getmtime(p) for p in saved]
    counts = [len(w.splitlines()) // 4 for w in inputs["want"]]
    host1 = tmh.partition_inputs(inputs["paths"], counts, 1, 2)
    rg = host1.rg_ids[0]
    first = b"".join(inputs["want"][rg].splitlines(keepends=True)[:4 * 60])
    with open(outs[rg], "wb") as f:
        f.write(first + b"garbage past the recorded bytes")
    with open(os.path.join(ck, "host1.json"), "w") as f:
        json.dump({"files_done": 0, "chunks": 1, "bytes": len(first)}, f)
    run_hosts(argv, tmp_path)
    _same(outs, inputs["want"])
    assert [os.path.getmtime(p) for p in saved] == mtimes
    assert json.load(open(os.path.join(ck, "host1.json"))) == \
        {"files_done": len(host1.rg_ids), "chunks": 0, "bytes": 0}
    from kbbq_tpu_torch.cli.main import main
    for name in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    capsys.readouterr()
    assert main(argv, device="cpu") == 1
    assert "num_processes" in capsys.readouterr().err


def test_a_host_with_no_file_joins_every_collective(inputs, tmp_path):
    """One input on two hosts: host 1 owns no file, takes empty steps in
    every collective (both layouts) and writes nothing."""
    for layout in ("replicated", "sharded"):
        out = str(tmp_path / f"{layout}.fq")
        jout = str(tmp_path / f"{layout}.want.fq")
        j_recalibrate_fastq(inputs["paths"][2], jout, JRecalConfig(**CFG))
        stats = run_hosts(_argv(inputs["paths"][2:], [out], "--bloom-layout",
                                layout), tmp_path)
        assert open(out, "rb").read() == open(jout, "rb").read()
        assert [s["host_reads_written"] for s in stats] == \
            [stats[0]["num_reads"], 0]
        assert stats[1]["windows"] == 0


def test_two_ranks_on_each_host(inputs, tmp_path):
    """Two hosts of two gloo ranks each (one group of four, global rank =
    host x 2 + local rank), the sharded layout: each rank takes every other
    window of its host's files, the host's first rank writes; the single
    host's bytes."""
    outs = _outs(tmp_path)
    stats = run_hosts(_argv(inputs["paths"], outs, "--bloom-layout",
                            "sharded", "--devices", "2"), tmp_path)
    _same(outs, inputs["want"])
    for s in stats:
        assert (s["devices"], s["local_devices"], s["timings"]["world"]) \
            == (4, 2, 4)
        assert len(s["timings"]["launches_by_rank"]) == 2
        assert s["timings"]["walk_rounds"] > 0

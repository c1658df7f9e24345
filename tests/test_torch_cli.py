"""The port's command line (kbbq_tpu_torch/cli/main.py) against the JAX
package's: the same argv through ``kbbq_tpu.cli.main.main`` and
``kbbq_tpu_torch.cli.main.main(..., device="cpu")``, in process, must write
the same bytes on every route (FASTQ, BAM, SAM and CRAM; whole-file and
streamed; reports), give the same exit codes and messages, and refuse what
the port does not have yet.  CRAM writes run under one pinned clock (their
gzip blocks stamp it).  Tolerance: exact equality.
"""

import gzip
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from kbbq_tpu.cli.main import main as jax_main
from kbbq_tpu.utils.synth import make_dataset, to_fastq_bytes

from kbbq_tpu_torch.cli.main import main as port_main
from kbbq_tpu_torch.io.bam import read_bam
from kbbq_tpu_torch.io.sam import serialize_sam
from kbbq_tpu_torch.utils.synth import (arrays_to_bam_bytes,
                                        arrays_to_cram_bytes,
                                        make_arrays_fast, read_starts)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "data", "tiny.fq")
FQ_ARGS = ["-k", "16", "-c", "15", "--batch-size", "64"]
BAM_ARGS = ["-k", "16", "-c", "18", "--batch-size", "64"]
CLOCK = 1.7e9


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    """Inputs of every route, written once: two FASTQs (each a read group),
    a gzip copy of the first, and the same alignments as BAM (three read
    groups, reverse-strand records, secondary and supplementary copies),
    as BAM with OQ tags, as SAM and as CRAM (containers of 128 records)."""
    root = tmp_path_factory.mktemp("cli")
    paths = {}
    for name, seed, err in (("fq", 61, 0.02), ("fq2", 62, 0.04)):
        ds = make_dataset(genome_len=800, read_len=50, coverage=15.0,
                          error_rate=err, seed=seed)
        paths[name] = root / f"{name}.fq"
        paths[name].write_bytes(to_fastq_bytes(ds))
    paths["fq_gz"] = root / "fq.fq.gz"
    paths["fq_gz"].write_bytes(gzip.compress(paths["fq"].read_bytes()))
    arrays, _ = make_arrays_fast(genome_len=3000, read_len=41, num_reads=400,
                                 seed=3)
    starts = read_starts(3000, 41, 400, 3)
    for name, kw in (("bam", {}), ("bam_oq", {"oq_quals": arrays.quals[::-1]
                                                .copy()})):
        paths[name] = root / f"{name}.bam"
        paths[name].write_bytes(arrays_to_bam_bytes(arrays, starts,
                                                    extra_share=0.05,
                                                    **kw)[0])
    paths["sam"] = root / "in.sam"
    paths["sam"].write_bytes(serialize_sam(read_bam(str(paths["bam"]))))
    paths["cram"] = root / "in.cram"
    paths["cram"].write_bytes(arrays_to_cram_bytes(
        arrays, starts, extra_share=0.05, records_per_container=128)[0])
    return {k: str(v) for k, v in paths.items()}


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)


def both(tmp_path, argv, capsysbinary=None):
    """Run `argv` through both command lines; "{o}" in an argument is a
    directory of each run's own.  Returns (JAX run, port run), each
    (exit code, {output file name: bytes}, stdout bytes, stderr text)."""
    runs = []
    for name, fn in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / name
        out.mkdir()
        args = [a.replace("{o}", str(out)) for a in argv]
        rc = fn(args) if fn is jax_main else fn(args, device="cpu")
        stdout, stderr = (capsysbinary.readouterr() if capsysbinary
                          else (b"", b""))
        files = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
        runs.append((rc, files, stdout, stderr.decode()))
    return runs


def assert_same(runs, n_files=1):
    (jrc, jfiles, jout, jerr), (trc, tfiles, tout, terr) = runs
    assert (jrc, trc) == (0, 0), (jerr, terr)
    assert len(jfiles) == n_files and all(jfiles.values())
    assert tfiles == jfiles
    assert tout == jout


def test_fastq_to_stdout_and_the_summary_line(d, tmp_path, capsysbinary):
    runs = both(tmp_path, ["recalibrate", d["fq"], *FQ_ARGS], capsysbinary)
    assert_same(runs, n_files=0)
    assert runs[0][2].startswith(b"@synth_read_0\n")
    n = runs[0][2].count(b"\n+\n")
    for _, _, _, err in runs:
        assert err.startswith(f"[kbbq-tpu] recalibrated {n} reads ({n * 50} "
                              f"bases) in ")
        assert err.endswith(" reads/s)\n")


@pytest.mark.parametrize("route", [
    "gz_input", "two_inputs_two_outputs", "interleaved", "gz_output",
    "stream_chunk_reads", "stream_gz_output", "implicit_recalibrate"])
def test_fastq_routes_write_the_jax_packages_bytes(d, tmp_path, route):
    argv = {
        "gz_input": ["recalibrate", d["fq_gz"], "-o", "{o}/out.fq"],
        "two_inputs_two_outputs": ["recalibrate", d["fq"], d["fq2"],
                                   "-o", "{o}/a.fq", "-o", "{o}/b.fq"],
        "interleaved": ["recalibrate", d["fq"], "--interleaved",
                        "-o", "{o}/out.fq"],
        "gz_output": ["recalibrate", d["fq"], d["fq2"], "-o",
                      "{o}/out.fq.gz"],
        "stream_chunk_reads": ["recalibrate", d["fq"], d["fq2"], "--stream",
                               "--chunk-reads", "64", "-o", "{o}/a.fq",
                               "-o", "{o}/b.fq"],
        "stream_gz_output": ["recalibrate", d["fq"], "--stream",
                             "-o", "{o}/out.fq.gz"],
        "implicit_recalibrate": [d["fq"], "-o", "{o}/out.fq"],
    }[route]
    runs = both(tmp_path, argv + FQ_ARGS)
    assert_same(runs, n_files=sum(a.startswith("{o}") for a in argv))
    if route.endswith("gz_output"):
        data = runs[1][1]["out.fq.gz"]
        assert data[:4] == b"\x1f\x8b\x08\x04"        # BGZF members
        assert gzip.decompress(data).count(b"\n+\n") > 200


@pytest.mark.parametrize("flag,stream", [("-s", False), ("-s", True),
                                         ("-u", False), ("-u", True)])
def test_bam_routes_write_the_jax_packages_bytes(d, tmp_path, flag, stream):
    src = d["bam_oq"] if flag == "-u" else d["bam"]
    argv = ["recalibrate", src, flag, "-o", "{o}/out.bam", *BAM_ARGS]
    if stream:
        argv += ["--stream", "--chunk-reads", "150"]
    assert_same(both(tmp_path, argv))


@pytest.mark.parametrize("out", ["out.sam", "-"])
def test_sam_in_and_out(d, tmp_path, capsysbinary, out):
    o = "-" if out == "-" else "{o}/" + out
    runs = both(tmp_path, ["recalibrate", d["sam"], "-s", "-o", o,
                           *BAM_ARGS], capsysbinary)
    assert_same(runs, n_files=int(out != "-"))
    text = runs[1][2] or runs[1][1]["out.sam"]
    assert text.startswith(b"@HD") and b"\tOQ:Z:" in text


@pytest.mark.parametrize("argv", [
    ["-o", "{o}/out.bam"],
    ["-s", "-o", "{o}/out.cram"],
    ["--stream", "-o", "{o}/out.cram"],
    ["--stream", "-o", "{o}/out.bam"],
], ids=["whole_to_bam", "whole_set_oq_to_cram", "stream_to_cram",
        "stream_to_bam_is_whole_file"])
def test_cram_routes_write_the_jax_packages_bytes(d, tmp_path, pinned, argv):
    assert_same(both(tmp_path, ["recalibrate", d["cram"], *argv,
                                *BAM_ARGS]))


@pytest.mark.parametrize("src,ext", [("fq", "fq"), ("bam", "bam")])
def test_report_out_then_applybqsr_and_apply_report(d, tmp_path, src, ext):
    args = FQ_ARGS if src == "fq" else BAM_ARGS
    (tmp_path / "direct").mkdir()
    direct = both(tmp_path / "direct", [
        "recalibrate", d[src], "--report-out", "{o}/r.report",
        "-o", f"{{o}}/out.{ext}", *args])
    assert_same(direct, n_files=2)
    assert direct[1][1]["r.report"].startswith(b"#:GATKReport.v1.1:3")
    report = str(tmp_path / "direct" / "port" / "r.report")
    for i, argv in enumerate((
            ["applybqsr", "-r", report, d[src]],
            ["recalibrate", "--apply-report", report, d[src]],
            ["recalibrate", "--apply-report", report, "--stream", d[src]])):
        (tmp_path / str(i)).mkdir()
        runs = both(tmp_path / str(i),
                    argv + ["-o", f"{{o}}/out.{ext}", *args])
        assert_same(runs)
        assert runs[1][1][f"out.{ext}"] == direct[1][1][f"out.{ext}"]


def test_benchmark_and_plot_subcommands(d, tmp_path):
    from kbbq_tpu_torch.oracle.kmers import decode_seq
    rng = np.random.default_rng(3)      # the generator's genome, replayed
    genome = rng.integers(0, 4, size=3000, dtype=np.int8)
    ref = tmp_path / "ref.fa"
    ref.write_bytes(b">synth\n" + decode_seq(genome) + b"\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_bytes(b"##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\n"
                    b"synth\t101\t.\tA\tT\n")
    runs = both(tmp_path, ["benchmark", "-b", d["bam"], "-r", str(ref),
                           "-v", str(vcf), "-l", "x", "-o", "{o}/b.tsv"])
    assert_same(runs)
    tsv = runs[1][1]["b.tsv"].decode().splitlines()
    assert tsv[0] == "label\treportedQ\tactualQ\tcount"
    assert sum(int(r.split("\t")[3]) for r in tsv[1:]) > 15000
    pytest.importorskip("matplotlib")
    (tmp_path / "port" / "b.tsv").write_bytes(runs[1][1]["b.tsv"])
    png = tmp_path / "b.png"
    assert port_main(["plot", str(tmp_path / "port" / "b.tsv"),
                      str(png)]) == 0
    assert png.stat().st_size > 1000


def test_exclusive_flags_and_exit_codes(d, tmp_path, capsys):
    for fn in (jax_main, port_main):
        with pytest.raises(SystemExit, match="exclusive"):
            fn(["recalibrate", d["fq"], "--report-out", "a",
                "--apply-report", "b"])
    missing = str(tmp_path / "missing.fq")
    bad = tmp_path / "bad.bam"
    bad.write_bytes(b"NOT A BAM FILE" * 8)
    for argv, code in ((["recalibrate", missing, "-o", "{o}/x.fq"], 2),
                       (["recalibrate", str(bad), "-o", "{o}/x.bam"], 1),
                       (["recalibrate", d["fq"], d["fq2"], "-o", "{o}/a.fq",
                         "-o", "{o}/b.fq", "-o", "{o}/c.fq"], 1)):
        for fn, sub in ((jax_main, "j"), (port_main, "t")):
            (tmp_path / sub).mkdir(exist_ok=True)
            args = [a.replace("{o}", str(tmp_path / sub)) for a in argv]
            kw = {} if fn is jax_main else {"device": "cpu"}
            assert fn(args, **kw) == code, (argv, sub)
        err = capsys.readouterr().err.splitlines()
        assert len(err) == 2 and err[0] == err[1], err
        assert err[0].startswith("kbbq-tpu: error: ")
    # a first argument that is no subcommand is an input to recalibrate
    assert port_main(["frobnicate"], device="cpu") == 2
    with pytest.raises(SystemExit) as e:            # argparse: no input
        port_main(["recalibrate"], device="cpu")
    assert e.value.code == 2


@pytest.mark.parametrize("flags,item", [
    (["--devices", "2"], None),
    (["--devices", "2", "--bloom-layout", "sharded"], None),
    (["--bloom-layout", "replicated"], None),
    (["--multihost"], None)])
def test_unported_options_are_refused_by_name(d, tmp_path, flags, item):
    """What is not ported is refused by its ROADMAP item, and no output is
    written; what is (item None: two ranks, on the CPU two processes over
    gloo, with the hash-space-sharded filters, and the replicated layout)
    writes the plain run's bytes and the JAX command line's; --multihost
    with no launcher variables is one host)."""
    out = tmp_path / "never.fq"
    if item is None:
        plain = tmp_path / "plain.fq"
        assert port_main(["recalibrate", d["fq"], "-o", str(plain),
                          *FQ_ARGS], device="cpu") == 0
        assert port_main(["recalibrate", d["fq"], "-o", str(out), *flags,
                          *FQ_ARGS], device="cpu") == 0
        assert out.read_bytes() == plain.read_bytes()
        jax_out = tmp_path / "jax.fq"
        assert jax_main(["recalibrate", d["fq"], "-o", str(jax_out), *flags,
                         *FQ_ARGS]) == 0
        assert out.read_bytes() == jax_out.read_bytes()
        return
    with pytest.raises(SystemExit) as e:
        port_main(["recalibrate", d["fq"], "-o", str(out), *flags],
                  device="cpu")
    assert item in str(e.value.code)
    assert not out.exists()


def test_devices_zero_and_one_run_on_one_device(d, tmp_path):
    """--devices 0 resolves to the card count (none here), --devices 1 is
    the single device: both give the plain run's bytes."""
    outs = []
    for i, flags in enumerate(([], ["--devices", "0"], ["--devices", "1"])):
        out = tmp_path / f"{i}.fq"
        assert port_main(["recalibrate", d["fq"], "-o", str(out), *flags,
                          *FQ_ARGS], device="cpu") == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == outs[2]


def test_python_m_help_and_no_card(tmp_path):
    """From a shell: `python -m kbbq_tpu_torch --help` exits 0; a run with
    no card fails naming CUDA and leaves no output (no CPU fallback)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-m", "kbbq_tpu_torch", "--help"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    for sub in ("recalibrate", "applybqsr", "benchmark", "plot"):
        assert sub in res.stdout
    out = tmp_path / "out.fq"
    res = subprocess.run([sys.executable, "-m", "kbbq_tpu_torch",
                          "recalibrate", TINY, "-o", str(out)], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert "CUDA" in res.stderr
    assert not out.exists()

"""The port stands alone: it (with its oracle, its scaling harness and its
config-5 and oracle spot-check scripts) imports neither jax nor anything of
kbbq_tpu, runs on the CPU only when asked, and raises without a CUDA device
otherwise.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kbbq_tpu_torch")


def test_port_runs_without_jax_or_kbbq_tpu(tmp_path):
    """In a fresh interpreter: import the port, run a tiny FASTQ -> FASTQ
    recalibration on the CPU, and look at sys.modules afterwards."""
    prog = f"""
import sys
import kbbq_tpu_torch
from kbbq_tpu_torch import (gatk_report, io, kernels, ops, oracle, pipeline,
                            state)
from kbbq_tpu_torch.ops import hash_cache, trusted
from kbbq_tpu_torch.io import (bam, bam_stream, bam_vec, bgzf, cram,
                               cram_codecs, cram_vec, cram_write, fasta,
                               native_lib, sam, stream)
from kbbq_tpu_torch.state import checkpoint
from kbbq_tpu_torch.utils import mem, synth
from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_bam,
                                     recalibrate_bam_streaming,
                                     recalibrate_cram,
                                     recalibrate_cram_stream_resident,
                                     recalibrate_fastq,
                                     recalibrate_fastq_streaming,
                                     stream_resident, streaming)
from kbbq_tpu_torch.pipeline import bam as pipeline_bam
from kbbq_tpu_torch.pipeline import cram_stream
from kbbq_tpu_torch.pipeline.recalibrate import apply_table_arrays
from kbbq_tpu_torch import benchmark, plot
from kbbq_tpu_torch.cli.main import main as cli_main
from kbbq_tpu_torch.utils import metrics
from kbbq_tpu_torch import parallel
from kbbq_tpu_torch.parallel import (mesh, merge, multihost,
                                     resident_sharded, sharded)
from kbbq_tpu_torch.oracle import (OracleBloom, OracleConfig,
                                   canonical_kmers, fmix32,
                                   infer_read_errors, kmer_hashes,
                                   recalibrate_reads, sample_hash,
                                   trusted_kmer_mask)
from kbbq_tpu_torch.oracle.pipeline import ReadBatch
import importlib.util
for rel in ("bench_scaling_torch.py", "scripts/torch_config5_rehearsal.py",
            "scripts/torch_oracle_spot.py"):
    spec = importlib.util.spec_from_file_location(
        rel.replace("/", "_")[:-3], {REPO!r} + "/" + rel)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
ds = synth.make_dataset(genome_len=600, read_len=40, coverage=8.0, seed=2)
oq, _ = recalibrate_reads(ReadBatch(ds.codes, ds.quals, ds.rgs, ds.seconds),
                          OracleConfig(k=16, coverage=8.0))
assert len(oq) == len(ds.codes)
cfg = RecalConfig(k=16, coverage=18.0, batch_size=64)
src = {os.path.join(REPO, 'tests', 'data', 'tiny.fq')!r}
assert cli_main(["recalibrate", src, "-k", "16", "-c", "18",
                 "-o", {str(tmp_path / 'cli.fq')!r}], device="cpu") == 0
recalibrate_fastq(src, {str(tmp_path / 'direct.fq')!r}, cfg, device="cpu",
                  report_out={str(tmp_path / 'recal.report')!r})
info = recalibrate_fastq(src, {str(tmp_path / 'out.fq')!r}, cfg,
                         device="cpu",
                         apply_report={str(tmp_path / 'recal.report')!r})
multihost.recalibrate_fastq_multihost(
    [src], [{str(tmp_path / 'mh.fq')!r}], cfg, device="cpu",
    info=multihost.init_multihost(num_processes=1, process_id=0))
recalibrate_fastq_streaming(src, {str(tmp_path / 'streamed.fq.gz')!r}, cfg,
                            chunk_reads=50, device="cpu",
                            checkpoint_dir={str(tmp_path / 'ck')!r})
arrays, _ = synth.make_arrays_fast(genome_len=4000, read_len=41,
                                   num_reads=600, seed=1)
data, _ = synth.arrays_to_bam_bytes(arrays,
                                    synth.read_starts(4000, 41, 600, 1),
                                    extra_share=0.1)
open({str(tmp_path / 'in.bam')!r}, "wb").write(data)
recalibrate_bam({str(tmp_path / 'in.bam')!r}, {str(tmp_path / 'w.sam')!r},
                cfg, set_oq=True, device="cpu")
recalibrate_bam({str(tmp_path / 'in.bam')!r}, {str(tmp_path / 'w.bam')!r},
                cfg, set_oq=True, device="cpu")
recalibrate_bam_streaming({str(tmp_path / 'in.bam')!r},
                          {str(tmp_path / 's.bam')!r}, cfg, set_oq=True,
                          chunk_records=100, device="cpu")
crm, _ = synth.arrays_to_cram_bytes(arrays,
                                    synth.read_starts(4000, 41, 600, 1),
                                    extra_share=0.1,
                                    records_per_container=128)
open({str(tmp_path / 'in.cram')!r}, "wb").write(crm)
recalibrate_cram({str(tmp_path / 'in.cram')!r}, {str(tmp_path / 'c.bam')!r},
                 cfg, device="cpu")
recalibrate_cram({str(tmp_path / 'in.cram')!r}, {str(tmp_path / 'c.cram')!r},
                 cfg, set_oq=True, device="cpu")
recalibrate_cram_stream_resident({str(tmp_path / 'in.cram')!r},
                                 {str(tmp_path / 's.cram')!r}, cfg,
                                 device="cpu")
def quals_of(path):
    b, o, z = bam.index_bam_bytes(bam.read_bam_bytes(path))[2:]
    return bam_vec.decode_machine_chunk(b, o, z, 41, None)[1]
print("SAMEQ", bool((quals_of({str(tmp_path / 'c.bam')!r})
                     == quals_of({str(tmp_path / 'w.bam')!r})).all()))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "kbbq_tpu" or m.startswith("kbbq_tpu."))
libs = sorted(set(ln.split()[-1] for ln in open("/proc/self/maps")
                  if "kbbq" in ln and ln.rstrip().endswith(".so")))
print("READS", info["num_reads"])
print("BAD", bad)
print("LIBS", libs)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", prog], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "BAD []" in res.stdout, res.stdout
    assert "READS 216" in res.stdout
    want = open(os.path.join(REPO, "tests", "data",
                             "tiny.recal.golden.fq"), "rb").read()
    assert (tmp_path / "out.fq").read_bytes() == want
    assert (tmp_path / "direct.fq").read_bytes() == want
    assert (tmp_path / "cli.fq").read_bytes() == want
    assert (tmp_path / "mh.fq").read_bytes() == want
    import gzip
    assert gzip.decompress((tmp_path / "streamed.fq.gz").read_bytes()) == want
    assert (tmp_path / "s.bam").read_bytes() == \
        (tmp_path / "w.bam").read_bytes()
    assert (tmp_path / "w.sam").read_bytes().startswith(b"@HD")
    for name in ("c.cram", "s.cram"):
        assert (tmp_path / name).read_bytes()[:4] == b"CRAM"
    # the CRAM input's reads get the BAM input's qualities
    assert "SAMEQ True" in res.stdout
    # the port's own codec is loaded, never the JAX package's build of its
    libs = res.stdout.split("LIBS ")[1]
    assert "kbbq_tpu_torch/build/libkbbq_io.so" in libs
    assert "kbbq_tpu/io/native" not in libs


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "bench_scaling_torch.py"),
             os.path.join(REPO, "scripts", "torch_config5_rehearsal.py"),
             os.path.join(REPO, "scripts", "torch_oracle_spot.py")]
    for root, _, names in os.walk(PORT):
        if os.path.basename(root) in ("build", "__pycache__"):
            continue
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return files


def test_no_source_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 20
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+kbbq_tpu\b(?!_)"
                     r"|from\s+kbbq_tpu(\.|\s))", re.M)
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad


@pytest.mark.parametrize("entry", ["run_pipeline", "recalibrate_fastq",
                                   "recalibrate_arrays_resident",
                                   "recalibrate_fastq_streaming",
                                   "recalibrate_arrays_windowed",
                                   "recalibrate_bam",
                                   "recalibrate_bam_streaming",
                                   "recalibrate_cram",
                                   "recalibrate_cram_stream_resident",
                                   "recalibrate_arrays_resident_sharded",
                                   "sharded_recalibrate_arrays"])
def test_entry_points_default_to_the_card_and_raise_without_one(
        entry, tmp_path, monkeypatch):
    """device=None means CUDA; with no CUDA device the call raises (and
    does not quietly run on the CPU)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from kbbq_tpu_torch import resolve_device
    from kbbq_tpu_torch.io.bam import BamFile
    from kbbq_tpu_torch.io.batcher import ReadArrays
    from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_bam,
                                         recalibrate_bam_streaming,
                                         recalibrate_fastq,
                                         recalibrate_arrays_windowed,
                                         recalibrate_fastq_streaming,
                                         run_pipeline)
    from kbbq_tpu_torch.pipeline.resident import recalibrate_arrays_resident
    arrays = ReadArrays(np.zeros((2, 20), np.int8), np.full((2, 20), 30,
                                                            np.int8),
                        np.ones((2, 20), bool), np.zeros(2, np.int32),
                        np.zeros(2, bool))
    cfg = RecalConfig(k=16)
    out = tmp_path / "never.fq"
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "run_pipeline":
            run_pipeline(arrays, cfg)
        elif entry == "recalibrate_fastq":
            recalibrate_fastq(os.path.join(REPO, "tests", "data", "tiny.fq"),
                              str(out), cfg)
        elif entry == "recalibrate_fastq_streaming":
            recalibrate_fastq_streaming(
                os.path.join(REPO, "tests", "data", "tiny.fq"), str(out), cfg)
        elif entry == "recalibrate_arrays_windowed":
            recalibrate_arrays_windowed(arrays, cfg)
        elif entry in ("recalibrate_cram",
                       "recalibrate_cram_stream_resident"):
            from kbbq_tpu_torch.io.bam import build_record
            from kbbq_tpu_torch.io.cram_write import write_cram
            from kbbq_tpu_torch.pipeline import (
                recalibrate_cram, recalibrate_cram_stream_resident)
            rec = build_record("r", np.zeros(20, np.int8),
                               np.full(20, 30, np.uint8))
            rec._rg_index = -1
            src = tmp_path / "in.cram"
            write_cram(BamFile("@HD\tVN:1.6\n", [], [rec]), str(src))
            out = tmp_path / "never.cram"
            {"recalibrate_cram": recalibrate_cram,
             "recalibrate_cram_stream_resident":
             recalibrate_cram_stream_resident}[entry](str(src), str(out), cfg)
        elif entry in ("recalibrate_bam", "recalibrate_bam_streaming"):
            from kbbq_tpu_torch.io.bam import build_record, serialize_bam
            src = tmp_path / "in.bam"
            src.write_bytes(serialize_bam(BamFile("", [], [build_record(
                "r", np.zeros(20, np.int8), np.full(20, 30, np.uint8))])))
            out = tmp_path / "never.bam"
            {"recalibrate_bam": recalibrate_bam,
             "recalibrate_bam_streaming": recalibrate_bam_streaming}[entry](
                str(src), str(out), cfg)
        elif entry == "recalibrate_arrays_resident_sharded":
            from kbbq_tpu_torch.parallel import \
                recalibrate_arrays_resident_sharded
            recalibrate_arrays_resident_sharded(arrays, cfg, 2)
        elif entry == "sharded_recalibrate_arrays":
            from kbbq_tpu_torch.parallel import sharded_recalibrate_arrays
            sharded_recalibrate_arrays(arrays, cfg, 2)
        else:
            recalibrate_arrays_resident(arrays, cfg)
    assert not out.exists()
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: handed a CPU tensor it must
    not fall back to anything."""
    import torch
    from kbbq_tpu_torch import kernels
    packed = torch.zeros(2048, dtype=torch.int32)
    x = torch.zeros(8, dtype=torch.int32)
    keep = torch.zeros(8, dtype=torch.bool)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        kernels.bloom_probe_hashed(packed, x, x, 7)
    with pytest.raises(ValueError):
        kernels.bloom_probe_words(packed, x, x)
    with pytest.raises(ValueError):
        kernels.bloom_probe_trust(packed, x.reshape(2, 4), x.reshape(2, 4),
                                  torch.ones(17, dtype=torch.int32), 16, 16)
    with pytest.raises(ValueError):
        kernels.bloom_or_words(packed, x, x, keep)
    with pytest.raises(ValueError):
        kernels.hash_only(torch.zeros((2, 40), dtype=torch.int8), 16, 7)
    with pytest.raises(ValueError):
        kernels.walk_errors(torch.zeros((2, 40), dtype=torch.int8),
                            torch.zeros((2, 25), dtype=torch.bool), packed,
                            16, 16, 7)
    with pytest.raises(ValueError):
        kernels.hash_keep(torch.zeros((2, 40), dtype=torch.int8), 0, 16, 7,
                          0)
    with pytest.raises(ValueError):
        kernels.trust_rule(keep.reshape(2, 4), x.reshape(2, 4),
                           torch.ones(17, dtype=torch.int32), 16, 16)
    with pytest.raises(ValueError):
        kernels.walk_start(torch.zeros((2, 40), dtype=torch.int8),
                           torch.zeros((2, 25), dtype=torch.bool), 16, 8)
    st = kernels.WalkState(2, 40, 16, "cpu", 8)
    with pytest.raises(ValueError):
        kernels.walk_propose(st, 7, 0, 4)
    with pytest.raises(ValueError):
        kernels.walk_resolve(st, torch.zeros(48, dtype=torch.uint8), 16, 4)
    assert kernels.LAUNCHES == before == {"bloom_probe": 0,
                                          "bloom_or_words": 0,
                                          "walk_errors": 0, "walk_round": 0}


def test_kernel_source_holds_the_three_kernels_and_their_notes():
    from kbbq_tpu_torch import kernels
    src = open(kernels.SOURCE).read()
    for name in ("bloom_probe_hashed_kernel", "bloom_probe_words_kernel",
                 "bloom_probe_trust_kernel", "bloom_or_words_kernel",
                 "hash_build_kernel", "walk_errors_kernel",
                 "walk_start_kernel", "walk_propose_kernel",
                 "walk_resolve_kernel"):
        assert f"__global__ void {name}(" in src
    for fn in ("kbbq_bloom_probe_hashed", "kbbq_bloom_probe_words",
               "kbbq_bloom_probe_trust", "kbbq_trust_rule",
               "kbbq_bloom_or_words", "kbbq_hash_build", "kbbq_hash_keep",
               "kbbq_hash_only", "kbbq_walk_errors", "kbbq_walk_start",
               "kbbq_walk_propose", "kbbq_walk_resolve"):
        assert re.search(rf"\bint {fn}\(", src)
    # one note per kernel: bloom_probe, bloom_or_words, walk_errors and
    # walk_round
    assert src.count("// Replaces:") == 4 and src.count("// Bound by:") == 4
    assert "torch/extension.h" not in src
    # the probe states its cache policy: streamed loads and stores for the
    # inputs and the output, an evict-last L2 hint for the filter word
    for word in ("__ldcs", "__stcs", "L2::evict_last", "L2::cache_hint"):
        assert word in src
    assert "arch=compute_90a,code=sm_90a" in " ".join(kernels.NVCC_FLAGS)
    assert os.path.relpath(kernels.BUILD_DIR, REPO) == os.path.join(
        "kbbq_tpu_torch", "build")


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")     # hide any card
    res = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

"""The port stands alone: it imports neither jax nor anything of kbbq_tpu,
runs on the CPU only when asked, and raises without a CUDA device
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
from kbbq_tpu_torch.io import (bam, bam_stream, bam_vec, bgzf, native_lib,
                               sam, stream)
from kbbq_tpu_torch.state import checkpoint
from kbbq_tpu_torch.utils import mem, synth
from kbbq_tpu_torch.pipeline import (RecalConfig, recalibrate_bam,
                                     recalibrate_bam_streaming,
                                     recalibrate_fastq,
                                     recalibrate_fastq_streaming,
                                     stream_resident, streaming)
from kbbq_tpu_torch.pipeline import bam as pipeline_bam
from kbbq_tpu_torch.pipeline.recalibrate import apply_table_arrays
cfg = RecalConfig(k=16, coverage=18.0, batch_size=64)
src = {os.path.join(REPO, 'tests', 'data', 'tiny.fq')!r}
recalibrate_fastq(src, {str(tmp_path / 'direct.fq')!r}, cfg, device="cpu",
                  report_out={str(tmp_path / 'recal.report')!r})
info = recalibrate_fastq(src, {str(tmp_path / 'out.fq')!r}, cfg,
                         device="cpu",
                         apply_report={str(tmp_path / 'recal.report')!r})
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
    import gzip
    assert gzip.decompress((tmp_path / "streamed.fq.gz").read_bytes()) == want
    assert (tmp_path / "s.bam").read_bytes() == \
        (tmp_path / "w.bam").read_bytes()
    assert (tmp_path / "w.sam").read_bytes().startswith(b"@HD")
    # the port's own codec is loaded, never the JAX package's build of its
    libs = res.stdout.split("LIBS ")[1]
    assert "kbbq_tpu_torch/build/libkbbq_io.so" in libs
    assert "kbbq_tpu/io/native" not in libs


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
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
                                   "recalibrate_bam_streaming"])
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
        elif entry in ("recalibrate_bam", "recalibrate_bam_streaming"):
            from kbbq_tpu_torch.io.bam import build_record, serialize_bam
            src = tmp_path / "in.bam"
            src.write_bytes(serialize_bam(BamFile("", [], [build_record(
                "r", np.zeros(20, np.int8), np.full(20, 30, np.uint8))])))
            out = tmp_path / "never.bam"
            {"recalibrate_bam": recalibrate_bam,
             "recalibrate_bam_streaming": recalibrate_bam_streaming}[entry](
                str(src), str(out), cfg)
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
    assert kernels.LAUNCHES == before == {"bloom_probe": 0,
                                          "bloom_or_words": 0,
                                          "walk_errors": 0}


def test_kernel_source_holds_the_three_kernels_and_their_notes():
    from kbbq_tpu_torch import kernels
    src = open(kernels.SOURCE).read()
    for name in ("bloom_probe_hashed_kernel", "bloom_probe_words_kernel",
                 "bloom_probe_trust_kernel", "bloom_or_words_kernel",
                 "hash_build_kernel", "walk_errors_kernel"):
        assert f"__global__ void {name}(" in src
    for fn in ("kbbq_bloom_probe_hashed", "kbbq_bloom_probe_words",
               "kbbq_bloom_probe_trust", "kbbq_bloom_or_words",
               "kbbq_hash_build", "kbbq_hash_only", "kbbq_walk_errors"):
        assert re.search(rf"\bint {fn}\(", src)
    assert src.count("// Replaces:") == 3 and src.count("// Bound by:") == 3
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

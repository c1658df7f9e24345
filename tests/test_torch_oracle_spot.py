"""scripts/torch_oracle_spot.py on the CPU: every check of ``oracle_spot``
counts 0 on a small run of the port (the streamed engine from a
checkpoint, and the resident route with its builds kept), and counts a
planted flip in filter B and in one output quality."""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "torch_oracle_spot", os.path.join(ROOT, "scripts",
                                          "torch_oracle_spot.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from kbbq_tpu_torch.utils.synth import arrays_to_fastq_file, \
        make_arrays_fast
    tmp = tmp_path_factory.mktemp("spot")
    arrays, _ = make_arrays_fast(genome_len=9000, read_len=80,
                                 num_reads=4000, error_rate=0.005, seed=4)
    src = str(tmp / "in.fq")
    arrays_to_fastq_file(arrays, src)
    return tmp, src


def _zero(mod, res):
    mod.check(res)
    assert all(res[n] == 0 for n in mod.CHECKS)


def test_streamed_run_equals_the_oracle(data):
    from kbbq_tpu_torch.pipeline import RecalConfig
    mod = _load()
    tmp, src = data
    res = mod.spot_fastq(src, RecalConfig(k=24, coverage=35.0), sample=250,
                         interleaved=True, device="cpu")
    _zero(mod, res)
    assert res["num_reads"] == 4000 and res["sample"] == 250
    assert (res["first_ordinal"], res["last_ordinal"]) == (0, 249 * 16)
    assert res["bases_marked"] > 0 and res["trusted_windows"] > 0


def test_resident_run_and_planted_flips(data):
    from kbbq_tpu_torch.oracle import canonical_kmers, kmer_hashes
    from kbbq_tpu_torch.oracle.kmers import probe_positions
    from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_fastq
    mod = _load()
    tmp, src = data
    cfg = RecalConfig(k=24, coverage=35.0)
    out = str(tmp / "res.fq")
    with mod.kept_resident_run() as kept:
        info = recalibrate_fastq(src, out, cfg, interleaved=True,
                                 device="cpu")
    tables = kept["captured"]["tables"]
    rows = mod.read_sample(src, out, mod.sample_ordinals(4000, 200),
                           tables.max_len, True)
    assert rows["num_reads"] == 4000
    args = (tables, kept["recal"][-1], rows["usable_bases"], cfg,
            info["total_bases"])
    a, b = kept["a"][-1], kept["b"][-1]
    _zero(mod, mod.oracle_spot(rows, a, b, *args, device="cpu"))

    # a trusted k-mer of the first read, its word of filter B cleared
    bloom_b = mod.unpacked_bloom(b, cfg.num_hashes)
    hi, lo, valid = canonical_kmers(rows["codes"][0], cfg.k)
    j = int(np.flatnonzero(valid & bloom_b.query(hi, lo))[0])
    h1, h2 = kmer_hashes(hi[j:j + 1], lo[j:j + 1])
    word = int(probe_positions(h1, h2, cfg.num_hashes,
                               bloom_b.params.log2_m)[0, 0]) // 32
    flipped = b.clone()
    flipped[word] = 0
    res = mod.oracle_spot(rows, a, flipped, *args, device="cpu")
    assert res["pass2_trusted_absent_from_b"] >= 1
    with pytest.raises(AssertionError, match="differs from the oracle"):
        mod.check(res)

    # one quality the run wrote, changed
    bad = dict(rows, out_quals=rows["out_quals"].copy())
    bad["out_quals"][7, 3] += 1
    res = mod.oracle_spot(bad, a, b, *args, device="cpu")
    assert res["pass4_mismatched_bases"] == 1
    assert sum(res[n] for n in mod.CHECKS) == 1

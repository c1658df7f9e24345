"""scripts/torch_config5_rehearsal.py on the CPU: the config-5 rehearsal
with both filters forced to 2^20 bits under the hash-space-sharded layout,
two host processes of one gloo rank each.  The pod's bytes equal the
single-process sharded run at D = 2, and each rank holds m/32/D words of
each filter."""

import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "torch_config5_rehearsal",
        os.path.join(ROOT, "scripts", "torch_config5_rehearsal.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rehearsal_two_hosts(tmp_path):
    mod = _load()
    out = mod.rehearse(reads=mod.READS, log2_ms=[20], shapes=[(2, 1)],
                       device="cpu", tmp=str(tmp_path))
    assert out["staged_reads"] == mod.READS == 12_000
    (run,) = out["runs"]
    assert (run["log2_m_a"], run["log2_m_b"]) == (20, 20)
    assert (run["hosts"], run["local"], run["world"]) == (2, 1, 2)
    assert run["shard_words"] == ((1 << 20) // 32 // 2,) * 2
    assert all(b > 0 for b in run["exchange_bytes"])
    # the pod's output files are the golden's (checked inside); all there
    for i in range(3):
        assert (tmp_path / f"pod_20_2x1_{i}.fq").read_bytes() == \
            (tmp_path / f"want_20_2_{i}.fq").read_bytes()
    assert (tmp_path / "pod_20_2x1_0.fq").stat().st_size > 0

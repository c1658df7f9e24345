"""bench_scaling_torch.py, the port's scaling harness: the point schema of
bench_scaling.py (tests/test_scaling_harness.py) over gloo ranks at 1, 2
and 4 devices with each filter layout, every point parity-gated against
the one-device bytes; the one-device run held to the JAX package's
resident route on the same arrays; the multi-host point from two host
processes."""

import importlib.util
import json
import os

import numpy as np

from _host_cases import run_hosts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"devices", "hosts", "wall_s", "reads_per_sec",
        "reads_per_sec_per_chip", "parity_vs_1dev", "efficiency_vs_1chip",
        "layout", "spawn_s"}


def _load():
    spec = importlib.util.spec_from_file_location(
        "bench_scaling_torch", os.path.join(ROOT, "bench_scaling_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_points_schema_and_parity():
    mod = _load()
    res = mod.run_points(num_reads=2000, read_len=60, k=16, batch_size=256,
                         devices_list=[1, 2, 4], repeats=1, device="cpu",
                         bloom_layout=("replicated", "sharded"))
    assert res["metric"] == "scaling_points"
    assert res["device_kind"] == "cpu" and res["card"] is None
    assert (res["num_reads"], res["read_len"]) == (2000, 60)
    pts = res["points"]
    assert [(p["devices"], p["layout"]) for p in pts] == [
        (1, "single-device"), (2, "replicated"), (2, "sharded"),
        (4, "replicated"), (4, "sharded")]
    for p in pts:
        assert set(p) == KEYS
        assert p["parity_vs_1dev"] is True
        assert p["reads_per_sec_per_chip"] > 0 and p["hosts"] == 1
        assert (p["spawn_s"] > 0) == (p["devices"] > 1)
    assert pts[0]["efficiency_vs_1chip"] == 1.0


def test_one_device_equals_the_jax_package():
    """The harness's data is the reference's (make_arrays_fast at 50x), and
    its D = 1 route gives the JAX package's resident bytes on it."""
    from kbbq_tpu.io.batcher import ReadArrays as JArrays
    from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
    from kbbq_tpu.pipeline.resident import recalibrate_arrays_resident as jr
    from kbbq_tpu.utils.synth import make_arrays_fast as j_make

    from kbbq_tpu_torch.pipeline import RecalConfig
    from kbbq_tpu_torch.pipeline.resident import recalibrate_arrays_resident
    mod = _load()
    arrays = mod._arrays(1500, 70)
    want_arrays, _ = j_make(genome_len=2100, read_len=70, num_reads=1500,
                            error_rate=0.005, seed=0)
    for name in ("codes", "quals", "mask", "rgs", "seconds"):
        assert np.array_equal(getattr(arrays, name),
                              getattr(want_arrays, name))
    got = recalibrate_arrays_resident(
        arrays, RecalConfig(k=24, coverage=50.0, batch_size=256),
        device="cpu")
    want = np.asarray(jr(JArrays(*(np.asarray(getattr(arrays, n)) for n in
                                   ("codes", "quals", "mask", "rgs",
                                    "seconds"))),
                         JRecalConfig(k=24, coverage=50.0, batch_size=256)))
    assert np.array_equal(got, want)


_PROGRAM = """
import json, os, sys, time
import torch.distributed as dist
sys.path.insert(0, {root!r})
import bench_scaling_torch as b
if os.environ["JAX_PROCESS_ID"] == "0":     # host 0 leaves each group late
    leave = dist.destroy_process_group
    dist.destroy_process_group = lambda *a, **k: (time.sleep(3),
                                                  leave(*a, **k))[1]
print(json.dumps(b.run_multihost(1200, 60, 16, 256, devices=1,
                                 device="cpu")))
"""


def test_multihost_point(tmp_path):
    """Two host processes of one gloo rank each: one group of 2, the shared
    FASTQ written once; host 0's point in the reference's schema.  Host 0
    leaves each group 3 s late, so host 1 starts the timed run's group
    while host 0 still holds the warm-up's, on the same coordinator: it
    must meet the new group, not the old one's store."""
    stats = run_hosts([], tmp_path, hosts=2,
                      env={"KBBQ_SCALING_TMP": str(tmp_path)},
                      program=_PROGRAM.format(root=ROOT))
    assert [s["process_index"] for s in stats] == [0, 1]
    for s in stats:
        assert s["metric"] == "scaling_multihost_point"
        assert (s["hosts"], s["devices"]) == (2, 2)
        assert s["reads_per_sec_per_chip"] == s["reads_per_sec"] / 2
        assert s["wall_s"] > 0 and s["card"] is None
    assert sorted(os.listdir(tmp_path)).count("scaling_1200_60.fq") == 1
    # host 0 holds the one input file; its output is the one-host bytes
    from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_fastq
    want = tmp_path / "one.fq"
    recalibrate_fastq(str(tmp_path / "scaling_1200_60.fq"), str(want),
                      RecalConfig(k=16, coverage=50.0, batch_size=256),
                      interleaved=True, device="cpu")
    assert (tmp_path / "scaling_out_p0.fq").read_bytes() == \
        want.read_bytes()
    print(json.dumps(stats[0]))

#!/usr/bin/env python3
"""Scaling harness of the PyTorch/CUDA port: the BASELINE measurement
points (1 card, the cards of 1 host, >= 2 hosts), reads/s/chip per point
and the efficiency against one card.  The port's counterpart of
``bench_scaling.py``, with its point schema.

One host, its cards (one process per card, NCCL; D = 1 in this process):
    python3 bench_scaling_torch.py --devices-list 1,2,4 \
        --bloom-layout replicated,sharded
Several hosts (one process per host, the same command on each):
    JAX_COORDINATOR=<host0:port> JAX_NUM_PROCESSES=<H> JAX_PROCESS_ID=<h> \
        python3 bench_scaling_torch.py --multihost

The data is ``make_arrays_fast`` with a genome of reads x length / 50 bases
(50x), error rate 0.005, seed 0.  D = 1 is the resident route in this
process (``recalibrate_arrays_resident``); D > 1 is ``run_pipeline`` with
``devices=D`` and a filter layout, which spawns its ranks on every call, so
each D > 1 wall holds their start-up (``spawn_s`` says how much).  Each
point is the best of ``--repeats`` runs after a warm-up, and is
parity-gated: every device count and layout must give the bytes of the
D = 1 run.  The last line of standard output is the JSON result; the line
before it the card's name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

COVERAGE = 50.0


def _log(msg):
    print(f"[scaling {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _arrays(num_reads: int, read_len: int):
    from kbbq_tpu_torch.utils.synth import make_arrays_fast
    genome_len = max(1000, int(num_reads * read_len / COVERAGE))
    arrays, _ = make_arrays_fast(genome_len=genome_len, read_len=read_len,
                                 num_reads=num_reads, error_rate=0.005,
                                 seed=0)
    return arrays


def _card(dev) -> str | None:
    if dev.type != "cuda":
        return None
    from kbbq_tpu_torch.utils.metrics import smi_line
    return smi_line()


def run_points(num_reads: int, read_len: int, k: int, batch_size: int,
               devices_list, repeats: int = 2, device=None,
               bloom_layout="replicated") -> dict:
    """The measurement points at each device count of `devices_list` that
    this host has, for each filter layout of `bloom_layout` (a name or a
    sequence of names; D = 1 has none) -> the schema of
    ``bench_scaling.py`` with ``layout`` and ``spawn_s`` in every point.
    device=None means the cards (raises without one); device="cpu" runs D
    gloo processes."""
    import torch

    from kbbq_tpu_torch import resolve_device
    from kbbq_tpu_torch.parallel.mesh import available_devices
    from kbbq_tpu_torch.pipeline import RecalConfig, run_pipeline
    from kbbq_tpu_torch.pipeline.resident import recalibrate_arrays_resident

    dev = resolve_device(device)
    layouts = ([bloom_layout] if isinstance(bloom_layout, str)
               else list(bloom_layout))
    avail = available_devices(dev.type)
    devices_list = [d for d in devices_list if d <= avail]
    arrays = _arrays(num_reads, read_len)
    cfg = RecalConfig(k=k, coverage=COVERAGE, batch_size=batch_size)

    def once(D, layout, t):
        if D == 1:
            out = recalibrate_arrays_resident(arrays, cfg, device=dev)
        else:
            out = run_pipeline(arrays, cfg, device=dev, devices=D,
                               bloom_layout=layout, timings=t)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    points = []
    golden = None
    for D in devices_list:
        for layout in (["single-device"] if D == 1 else layouts):
            _log(f"D={D} {layout}: warm-up")
            once(D, layout, {})
            best = None
            for rep in range(repeats):
                t: dict = {}
                t0 = time.time()
                out = once(D, layout, t)
                dt = time.time() - t0
                _log(f"D={D} {layout} run {rep}: {dt:.3f} s, spawn "
                     f"{t.get('spawn', 0.0)} s")
                if best is None or dt < best[0]:
                    best = (dt, t.get("spawn", 0.0))
            if golden is None:
                golden = out
            parity = bool(out.shape == golden.shape
                          and (out == golden).all())
            rps = num_reads / best[0]
            points.append({
                "devices": D, "hosts": 1, "layout": layout,
                "wall_s": best[0], "spawn_s": best[1],
                "reads_per_sec": rps, "reads_per_sec_per_chip": rps / D,
                "parity_vs_1dev": parity})
            _log(f"D={D} {layout}: {rps:.0f} reads/s ({rps / D:.0f}/chip), "
                 f"parity={parity}")

    base = points[0]["reads_per_sec_per_chip"] if points else 1.0
    for p in points:
        p["efficiency_vs_1chip"] = p["reads_per_sec_per_chip"] / base
    return {
        "metric": "scaling_points",
        "unit": "reads/s/chip per measurement point",
        "device_kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "card": _card(dev),
        "num_reads": num_reads,
        "read_len": read_len,
        "points": points,
    }


def run_multihost(num_reads: int, read_len: int, k: int, batch_size: int,
                  devices: int | None = None, device=None) -> dict:
    """The >= 2 hosts point: every host runs this same call with the
    launcher's variables (``JAX_COORDINATOR``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``).  Host 0 writes the shared FASTQ once (into
    ``KBBQ_SCALING_TMP``, else the temporary directory), the others wait
    for it; then ``recalibrate_fastq_multihost`` over `devices` local ranks
    (default every card), a warm-up and one timed run.  The partition is
    by file, as the reference's, so with its one file host 0's ranks do the
    passes and the other hosts join every collective with empty steps."""
    import tempfile

    from kbbq_tpu_torch import resolve_device
    from kbbq_tpu_torch.parallel.multihost import (
        init_multihost,
        recalibrate_fastq_multihost,
    )
    from kbbq_tpu_torch.pipeline import RecalConfig
    from kbbq_tpu_torch.utils.synth import arrays_to_fastq_file

    dev = resolve_device(device)
    info = init_multihost()
    pid = info["process_id"]
    tmp = os.environ.get("KBBQ_SCALING_TMP", tempfile.gettempdir())
    in_fq = os.path.join(tmp, f"scaling_{num_reads}_{read_len}.fq")
    if pid == 0 and not os.path.exists(in_fq):
        arrays_to_fastq_file(_arrays(num_reads, read_len), in_fq + ".tmp")
        os.replace(in_fq + ".tmp", in_fq)
    deadline = time.time() + 1800
    while not os.path.exists(in_fq):
        if time.time() > deadline:
            raise TimeoutError(f"host 0 wrote no {in_fq}")
        time.sleep(0.5)
    cfg = RecalConfig(k=k, coverage=COVERAGE, batch_size=batch_size)
    out_fq = os.path.join(tmp, f"scaling_out_p{pid}.fq")

    def once(t):
        return recalibrate_fastq_multihost(
            [in_fq], [out_fq], cfg, interleaved=True, info=info,
            devices=devices, device=device, timings=t)

    once(None)                                            # warm-up
    t: dict = {}
    t0 = time.time()
    stats = once(t)
    dt = time.time() - t0
    chips = stats["devices"]
    rps = num_reads / dt
    return {
        "metric": "scaling_multihost_point",
        "hosts": info["num_processes"],
        "devices": chips,
        "layout": stats["bloom_layout"],
        "wall_s": dt,
        "spawn_s": t["spawn"],
        "reads_per_sec": rps,
        "reads_per_sec_per_chip": rps / chips,
        "process_index": pid,
        "card": _card(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--len", type=int, default=150, dest="read_len")
    ap.add_argument("-k", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--devices-list", default=None,
                    help="comma list of device counts (default: 1 and "
                         "every local card)")
    ap.add_argument("--multihost", action="store_true",
                    help="the >= 2 hosts point (one identical process per "
                         "host, under the launcher's JAX_* variables)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--bloom-layout", default="replicated",
                    help="comma list of filter layouts for D > 1 "
                         "(replicated, sharded)")
    args = ap.parse_args(argv)

    import torch
    if args.multihost:
        result = run_multihost(args.reads, args.read_len, args.k,
                               args.batch_size)
        if result["process_index"] == 0:
            print(result["card"], flush=True)
            print(json.dumps(result), flush=True)
        return 0

    avail = torch.cuda.device_count()
    if args.devices_list:
        dl = [int(x) for x in args.devices_list.split(",")]
    else:
        dl = [1] if avail <= 1 else sorted({1, avail})
    result = run_points(args.reads, args.read_len, args.k, args.batch_size,
                        dl, repeats=args.repeats,
                        bloom_layout=args.bloom_layout.split(","))
    print(result["card"], flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the check, the result.

A run is a batch of samples recalibrated back to back, as a lab's pipeline
runs them (a closed loop of one client):

- set-up: import the program and load its kernels, generate the sample from
  the seed with the frozen generators, write its input file once under
  ``TMPDIR``, and run the warm-up jobs;
- window: jobs run back to back while the window is open, and the last job
  that starts inside it finishes and counts.  A job is one whole sample,
  file to file, through the program's public entry point named by the
  traffic; its output goes to an in-memory writable, which is what the
  check judges.  The input is read again by every job (from the page
  cache);
- check: once the window has closed and the device peak is read, the
  plain reference (``reference/``) recalibrates the same reads and every
  distinct output of the window is compared with what it must be;
- result: the metrics the manifest names for the cell, by their readers,
  and the last line of standard output as the driver reads it.

The traced run (``--trace 1``) passes a ``timings`` dict to the entry
point, so the program's stage clock synchronises the device at every stage
boundary, and records the window with ``torch.profiler``.  Nothing of the
program is patched: the idle gaps of ``breakdown`` are labelled from the
device's own activity (``harness/trace.py``).

Just before the result is printed, after the window, the reference, the
judge and every metric reader, ``sys.modules`` is searched for JAX and the
JAX package; a hit raises ``ForbiddenModules`` and no result is printed.
"""

from __future__ import annotations

import gc
import importlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from . import memory, modules, spec, synth, trace

# what each compared number may reach: every byte must be the reference's
LIMITS = {"qual_bytes_wrong": 0, "other_bytes_wrong": 0}


class NoDevice(RuntimeError):
    pass


def _entry(path: str):
    mod, _, fn = path.partition(":")
    return getattr(importlib.import_module(mod), fn)


def make_sample(cfg: dict, seed: int, tmpdir: str):
    """(reads, input path, reference inputs, layout, records a job): the
    sample of configuration `cfg` drawn from `seed` and written by its
    input format (``formats/<format>.py``); the reference inputs are the
    reads in the order the program decodes them."""
    s = cfg["sample"]
    reads = synth.make_reads(s["genome_len"], s["read_len"], s["num_reads"],
                             s["error_rate"], seed, s.get("paired", True))
    path, ref_in, lay, records = spec.input_format(cfg["format"]).write(
        tmpdir, reads, cfg)
    return reads, path, ref_in, lay, records


def expected_output(cfg: dict, reads, lay, new_quals):
    """What the program must write, by the configuration's input format."""
    return spec.input_format(cfg["format"]).expected(reads, lay, new_quals,
                                                     cfg)


def reference_quals(cfg: dict, ref_in: dict, device, **variant):
    """New qualities and work counts of the plain reference."""
    from ..reference.recal import recalibrate
    r = cfg["recal"]
    return recalibrate(ref_in["codes"], ref_in["quals"], ref_in["rgs"],
                       ref_in["seconds"], ref_in["num_rg"], r["k"],
                       r["coverage"], device, **variant)


def run_window(entry, path: str, rcfg, kwargs: dict, seconds: float,
               traced: bool, sync):
    """Jobs back to back until `seconds` have passed since the first
    started; the last job that starts inside the window finishes.  The
    host's resident set is sampled through the first job only (its peak
    rise goes into that job's ``peak_host_bytes``), so no sampler runs
    beside the later jobs.  -> (jobs, window_s, outputs, trace summary or
    None, error text or None)."""
    import torch
    jobs, outputs = [], []
    error = None
    prof = None
    if traced:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    with memory.RssWatch() as watch:
        w0 = time.perf_counter()
        while not jobs or time.perf_counter() - w0 < seconds:
            sink = io.BytesIO()
            timings = {} if traced else None
            if not jobs:
                rss0 = memory.rss()
                watch.mark()
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(trace.JOB):
                    entry(path, sink, rcfg, timings=timings, **kwargs)
                    sync()
            except Exception as e:   # a failed job ends the window
                error = f"{type(e).__name__}: {e}"
                jobs.append({"start": t0 - w0,
                             "end": time.perf_counter() - w0,
                             "failed": True})
                break
            t1 = time.perf_counter()
            job = {"start": t0 - w0, "end": t1 - w0, "failed": False,
                   "timings": timings}
            if not jobs:
                job["peak_host_bytes"] = watch.mark() - rss0
                watch.stop()
            jobs.append(job)
            outputs.append(sink)
    window_s = jobs[-1]["end"]
    summary = None
    if prof is not None:
        prof.stop()
        summary = trace.reduce(prof.events())
        del prof
    return jobs, window_s, outputs, summary, error


def judge(expected, outputs) -> list:
    """The compared numbers of every job's output (a distinct output is
    judged once)."""
    from ..reference.outputs import same_bytes
    seen = []
    out = []
    for sink in outputs:
        data = sink.getbuffer()
        for prev, verdict in seen:
            if same_bytes(prev, data):
                out.append(verdict)
                break
        else:
            verdict = expected.judge(data)
            seen.append((data, verdict))
            out.append(verdict)
    return out


def _device_info(torch, dev, chips: int, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        t_start: float, device: str | None = None, entry=None,
        cell: dict | None = None, out=sys.stdout, err=sys.stderr) -> dict:
    """One run; prints the result line and returns it.  `device` None means
    the CUDA cards the cell asks for (NoDevice without them); the tests
    pass "cpu", a `cell` of their own size (as ``spec.cell`` gives it) and
    may put a broken `entry` in the program's place."""
    cell = cell or spec.cell(cell_name)
    cfg, tr = cell["config"], cell["traffic"]
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(
                f"cell {cell_name} needs {cell['chips']} CUDA device(s); "
                f"torch sees {torch.cuda.device_count()}")
        dev = torch.device("cuda")
        kw_dev = {}

        def sync():
            torch.cuda.synchronize(dev)
    else:
        dev = torch.device(device)
        kw_dev = {"device": dev}

        def sync():
            pass
    from kbbq_tpu_torch.pipeline import RecalConfig
    entry = entry or _entry(tr["entry"])
    rcfg = RecalConfig(**cfg["recal"])
    kwargs = {**cfg.get("entry_kwargs", {}), **tr.get("kwargs", {}),
              **kw_dev}
    tmpdir = tempfile.mkdtemp(prefix="bqsr_bench_")
    phases = {"imports": time.perf_counter() - t_start}

    def phase(name, t0):
        phases[name] = time.perf_counter() - t0
        return time.perf_counter()
    try:
        t = time.perf_counter()
        reads, path, ref_in, lay, records = make_sample(cfg, seed, tmpdir)
        t = phase("sample", t)
        for _ in range(int(tr.get("warmup_jobs", 1))):
            entry(path, io.BytesIO(), rcfg, **kwargs)
        sync()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t = phase("warmup", t)
        setup_s = time.perf_counter() - t_start
        jobs, window_s, outputs, summary, error = run_window(
            entry, path, rcfg, kwargs, seconds, traced, sync)
        if traced:
            peak = max([v for j in jobs for k, v in
                        (j.get("timings") or {}).items()
                        if k.endswith("_peak_bytes")], default=0)
        else:
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        new_quals, counts = reference_quals(cfg, ref_in, dev)
        t = phase("reference", t)
        expected = expected_output(cfg, reads, lay, new_quals)
        del new_quals
        verdicts = judge(expected, outputs)
        del outputs, expected
        phase("judge", t)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    checks = {name: {"value": max([v[name] for v in verdicts],
                                  default=0), "limit": limit}
              for name, limit in LIMITS.items()}
    failed = sum(1 for j in jobs if j["failed"]) + sum(
        1 for v in verdicts if any(v[n] > LIMITS[n] for n in LIMITS))
    ok = [j for j in jobs if not j["failed"]]
    state = {"cell": cell_name, "config": cfg, "traffic": tr,
             "traced": traced, "setup_s": setup_s, "window_s": window_s,
             "jobs": ok, "records_per_job": records,
             "peak_device_bytes": peak, "trace": summary, "counts": counts}
    metrics = {}
    for m in cell["per_layer" if traced else "end_to_end"]:
        value = spec.reader(m["name"])(state) if ok else None
        if value is None:
            print(f"[bench] metric {m['name']}: nothing to read",
                  file=err, flush=True)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = modules.forbidden()
    if found:
        raise modules.ForbiddenModules(found)
    device = _device_info(torch, dev, cell["chips"], peak)
    if traced and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = window_s
    result = {"correct": bool(ok) and failed == 0 and error is None,
              "attempted": len(jobs), "failed": failed, "metrics": metrics,
              "device": device}
    if traced and summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    print("[bench] seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()) + f"; window {window_s:.3f}"
        f" ({len(jobs)} jobs: " + " ".join(
            f"{j['end'] - j['start']:.3f}" for j in jobs) + "); host peak "
        + " ".join(f"{j['peak_host_bytes']}" for j in ok
                   if "peak_host_bytes" in j), file=err, flush=True)
    if error is not None:
        print(f"[bench] job failed: {error}", file=err, flush=True)
    for name, c in checks.items():
        print(f"[check] {name} {c['value']} limit {c['limit']}", file=err,
              flush=True)
    print(json.dumps(result), file=out, flush=True)
    return result


# the controls: the reference put in the program's place, a step below
# what the configuration states
CONTROLS = {"float32_deltas": {"delta_dtype": np.float32},
            "half_filters": {"filter_log2_shift": -1}}


def control_readings(cell: dict, seed: int, device=None) -> dict:
    """The compared numbers of one job of the program and of each control
    on the sample of `seed` (no window: the numbers are the check's, not
    the metrics')."""
    import torch
    cfg, tr = cell["config"], cell["traffic"]
    from kbbq_tpu_torch.pipeline import RecalConfig
    dev = torch.device(device or "cuda")
    kwargs = {**cfg.get("entry_kwargs", {}), **tr.get("kwargs", {})}
    if device is not None:
        kwargs["device"] = dev
    tmpdir = tempfile.mkdtemp(prefix="bqsr_bench_")
    try:
        reads, path, ref_in, lay, _ = make_sample(cfg, seed, tmpdir)
        sink = io.BytesIO()
        _entry(tr["entry"])(path, sink, RecalConfig(**cfg["recal"]),
                            **kwargs)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    want, counts = reference_quals(cfg, ref_in, dev)
    expected = expected_output(cfg, reads, lay, want)
    out = {"seed": seed, "program": expected.judge(sink.getbuffer()),
           "marks": counts["marks"]}
    for name, variant in CONTROLS.items():
        got, _ = reference_quals(cfg, ref_in, dev, **variant)
        out[name] = expected.judge(
            expected_output(cfg, reads, lay, got).as_written())
        out[name]["quals_differing"] = int((got != want).sum())
    return out

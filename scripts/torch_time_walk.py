#!/usr/bin/env python3
"""Time the walk_errors kernel of one or more trees of kbbq_tpu_torch on one
chunk of reads, on the card, two ways.

    python3 scripts/torch_time_walk.py [--reads 65536] ROOT [ROOT ...]

Each ROOT is a directory that holds a ``kbbq_tpu_torch`` package (a checkout
of this repository, or an unpacked ``git archive`` of another commit); each
is timed in a process of its own, in the order given, so naming a tree twice
(parent, change, change, parent) shows the drift of the card.  Every tree
builds its own kernels.  Per tree one JSON line: the device time of one launch
from a CUDA graph of 20 launches (the card never waits for the host), and the
time between two CUDA events around a single call of ``infer_errors`` (which
includes the host's work to enqueue the launch: what the event pair of
chip_smoke.py measured before it timed short kernels from a graph); and, from
graphs again, the same launch with every window trusted (no read has a break:
what is left is loading, scanning and storing) and on the first 1, 32, 1024
and 8192 reads (how the time grows with the number of blocks).  The data
is chip_smoke.py's: reads of 150 bases from a genome at 50x, errors at 0.005,
k = 32, filter B from the trusted windows; only functions that every tree has
are used to make it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys


def _chip_smoke():
    """This checkout's chip_smoke.py, for its timing helpers (cuda_ms,
    cuda_graph_ms, smi_line): loaded by path, whatever tree is timed."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(root: str, reads: int) -> dict:
    smoke = _chip_smoke()
    sys.path.insert(0, root)
    import torch
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.ops import bloom as tb
    from kbbq_tpu_torch.ops.inference import infer_errors, infer_errors_plain
    from kbbq_tpu_torch.ops.trusted import trusted_mask_batch
    from kbbq_tpu_torch.oracle import (alpha_threshold, bloom_params_for,
                                       coverage_thresholds)
    from kbbq_tpu_torch.pipeline import RecalConfig
    try:
        from kbbq_tpu_torch.ops.hash_cache import hash_cache_chunk
    except ImportError:         # a tree from before the hash pass moved
        from kbbq_tpu_torch.pipeline.resident import hash_cache_chunk
    from kbbq_tpu_torch.utils.synth import make_arrays_fast

    dev = torch.device("cuda")
    cfg = RecalConfig(k=32, coverage=50.0)
    k, h, L = cfg.k, cfg.num_hashes, 150
    arrays, _ = make_arrays_fast(genome_len=max(10_000, reads * 3),
                                 read_len=L, num_reads=reads,
                                 error_rate=0.005, seed=0, paired=True)
    n = L - k + 1
    alpha, coverage = cfg.resolve_alpha(reads * L)
    pa, pb = bloom_params_for(cfg, reads * n, alpha, coverage)
    codes = torch.from_numpy(arrays.codes).to(dev)
    ids = torch.arange(reads, dtype=torch.int64, device=dev)
    h1, word, keep = hash_cache_chunk(codes, ids, k, h,
                                      int(alpha_threshold(alpha)))
    filt_a = tb.bloom_build_words(h1, word, keep, pa.log2_m)
    hits = tb.bloom_query_words(filt_a, h1, word)
    t_table = torch.from_numpy(coverage_thresholds(alpha, k)).to(dev)
    trusted = trusted_mask_batch(hits, word != 0, t_table, k,
                                 cfg.trust_threshold)
    filt_b = tb.bloom_build_words(h1, word, trusted, pb.log2_m)
    tr0 = tb.bloom_query_words(filt_b, h1, word)

    def walk():
        return infer_errors(filt_b, codes, k, h, cfg.ext_cap, trusted0=tr0)

    err = walk()
    want = infer_errors_plain(filt_b, codes, k, h, cfg.ext_cap, trusted0=tr0)
    torch.cuda.synchronize()
    mismatches = int((err != want).sum())

    def graph_ms(fn):
        return smoke.cuda_graph_ms(fn, launches=20, reps=9)

    all_trusted = torch.ones_like(tr0)
    return {"root": root, "reads": reads, "marks": int(want.sum()),
            "mismatches": mismatches,
            "graph_ms_per_launch": graph_ms(walk),
            "between_events_ms": smoke.cuda_ms(walk, reps=9),
            "graph_ms_all_windows_trusted": graph_ms(lambda: infer_errors(
                filt_b, codes, k, h, cfg.ext_cap, trusted0=all_trusted)),
            "graph_ms_first_reads": {
                nr: graph_ms(lambda: infer_errors(
                    filt_b, codes[:nr], k, h, cfg.ext_cap,
                    trusted0=tr0[:nr]))
                for nr in (1, 32, 1024, 8192) if nr <= reads},
            "launches_counted": kernels.LAUNCHES["walk_errors"],
            "card": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(time_tree(args.roots[0], args.reads)), flush=True)
        return 0
    print(_chip_smoke().smi_line(), flush=True)
    for root in args.roots:
        subprocess.run([sys.executable, __file__, "--one", "--reads",
                        str(args.reads), root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

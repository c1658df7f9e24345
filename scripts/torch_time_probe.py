#!/usr/bin/env python3
"""Time the bloom_probe kernel of one or more trees of kbbq_tpu_torch on the
card.

    python3 scripts/torch_time_probe.py [--reads 1533333] ROOT [ROOT ...]

Each ROOT is a directory that holds a ``kbbq_tpu_torch`` package (a checkout
of this repository, or an unpacked ``git archive`` of another commit); each
is timed in a process of its own, in the order given, so naming a tree twice
(parent, change, change, parent) shows the drift of the card.  Every tree
builds its own kernels.  Per tree one JSON line, every time the card's own
for one launch out of a CUDA graph: the cached word test of every window
against filters of 2^26, 2^28 and 2^30 bits built from one hash cache (8 MiB
sits in L2 whatever the policy, 128 MiB cannot), each held to the plain
version first, and the hashed entry point on the k-mers of 65,536 reads.  The
data is chip_smoke.py's: reads of 150 bases from a genome at 50x, errors at
0.005, k = 32; only functions that every tree since the fused hash pass has
are used.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys


def _chip_smoke():
    """This checkout's chip_smoke.py, for its timing helpers (cuda_graph_ms,
    smi_line): loaded by path, whatever tree is timed."""
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
    from kbbq_tpu_torch.ops.hash_cache import hash_cache_build
    from kbbq_tpu_torch.ops.kmers import canonical_kmers_batch
    from kbbq_tpu_torch.oracle import alpha_threshold
    from kbbq_tpu_torch.pipeline import RecalConfig
    from kbbq_tpu_torch.utils.synth import make_arrays_fast

    dev = torch.device("cuda")
    cfg = RecalConfig(k=32, coverage=50.0)
    k, h, L = cfg.k, cfg.num_hashes, 150
    arrays, _ = make_arrays_fast(genome_len=max(10_000, reads * 3),
                                 read_len=L, num_reads=reads,
                                 error_rate=0.005, seed=0, paired=True)
    alpha, _ = cfg.resolve_alpha(reads * L)
    codes = torch.from_numpy(arrays.codes).to(dev)
    h1, word, keep, filt_a = hash_cache_build(
        codes, 0, k, h, int(alpha_threshold(alpha)), 28)

    mismatches = 0
    words_ms = {}
    for log2_m in (26, 28, 30):
        filt = filt_a if log2_m == 28 else \
            tb.bloom_build_words(h1, word, keep, log2_m)
        mismatches += int((kernels.bloom_probe_words(filt, h1, word) !=
                           tb.bloom_query_words_plain(filt, h1, word)).sum())
        words_ms[log2_m] = smoke.cuda_graph_ms(
            lambda: kernels.bloom_probe_words(filt, h1, word), launches=5)

    hi, lo, _ = canonical_kmers_batch(codes[:min(65536, reads)], k)
    del filt
    mismatches += int((kernels.bloom_probe_hashed(filt_a, hi, lo, h) !=
                       tb.bloom_query_rows_plain(filt_a, hi, lo, h)).sum())
    hashed_ms = smoke.cuda_graph_ms(
        lambda: kernels.bloom_probe_hashed(filt_a, hi, lo, h))
    return {"root": root, "reads": reads, "windows": h1.numel(),
            "mismatches": mismatches,
            "words_graph_ms_by_log2_m": words_ms,
            "hashed_kmers": hi.numel(), "hashed_graph_ms": hashed_ms,
            "launches_counted": kernels.LAUNCHES["bloom_probe"],
            "card": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reads", type=int, default=1_533_333)
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

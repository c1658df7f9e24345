#!/usr/bin/env python3
"""Oracle spot check of a run at scale: every pass of the port held to its
NumPy oracle on a sample of reads, against the filters the run built.

    python3 scripts/torch_oracle_spot.py reads.fq -k 32 -c 30 --interleaved

The port of ``scripts/chr20_oracle_spot.py``, widened to every pass.  A
parity check between the card and the plain versions compares one engine
with itself; this one breaks the circle at full size: the run's packed
filters are unpacked bit by bit into the oracle's byte-per-slot filters
(``OracleBloom``), and on a sample of reads spread over every ordinal of
the input (every floor(n/S)-th read: sampling keys on the global ordinal)
``oracle_spot`` counts, each exactly:

1. pass 1: k-mers the oracle keeps (valid, sample_hash <= threshold) that
   the run's filter A lacks;
2. pass 2: reads whose oracle trust mask (``trusted_kmer_mask`` against
   filter A) differs from the card's fused trust probe, and trusted
   k-mers that filter B lacks;
3. pass 3: reads whose oracle walk (``infer_read_errors`` against filter
   B) differs from the card's ``walk_errors``;
4. covariates: cells where the oracle's tables of the sample (its own
   errors) differ from the card's histogram of it (the card's marks), and
   the difference between the run's table total and the bases the oracle's
   skip rule counts over every read;
5. deltas and pass 4: cells where ``build_recal_table`` of the run's tables
   differs from the run's Q' table, and sample bases where the oracle's
   pass-4 gather differs from the qualities the run wrote.

``main`` runs the streamed engine on one FASTQ with a checkpoint (filters
A and B and the tables are its files, the Q' table is kept as the run
computes it), then checks ``--sample`` reads (default 8192).  Any mismatch
raises, so the exit code is non-zero; the last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SAMPLE = 8192
CHECKS = ("pass1_absent_from_a", "pass2_trust_mismatched_reads",
          "pass2_trusted_absent_from_b", "pass3_mismatched_reads",
          "covariate_mismatched_cells", "table_total_difference",
          "delta_mismatched_cells", "pass4_mismatched_bases")


def _log(msg):
    print(f"[spot {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


@contextlib.contextmanager
def keep_results(module, name: str, pick=lambda r: r):
    """While open, every call of ``module.<name>`` also appends
    ``pick(result)`` to the list this yields (a run's filters and Q' table,
    taken as the run builds them)."""
    fn = getattr(module, name)
    kept: list = []

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        kept.append(pick(out))
        return out

    setattr(module, name, wrapped)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def kept_resident_run():
    """While open, the resident route (``pipeline/resident.py``) keeps what
    it builds, in the dict this yields: lists ``a`` and ``b`` (filters A and
    B, packed words on its device), ``recal`` (Q' tables) and
    ``captured`` (``captured_tables``': its ``tables`` are those of the
    last run)."""
    from kbbq_tpu_torch.oracle import captured_tables
    from kbbq_tpu_torch.pipeline import resident
    with keep_results(resident, "hash_cache_build", lambda r: r[3]) as a, \
            keep_results(resident, "bloom_build_words") as b, \
            keep_results(resident, "build_recal_table") as recal, \
            captured_tables() as cap:
        yield {"a": a, "b": b, "recal": recal, "captured": cap}


def unpacked_bloom(words, num_hashes: int):
    """The oracle's byte-per-slot filter of a packed one (int32 bit
    patterns or uint32 words, a tensor or an array, m/32 of them): slot
    b*32 + j is bit j of word b."""
    import torch

    from kbbq_tpu_torch.oracle import BloomParams, OracleBloom
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    words = np.ascontiguousarray(words).view("<u4")
    log2_m = (words.size * 32).bit_length() - 1
    if words.size * 32 != 1 << log2_m:
        raise ValueError(f"{words.size} words are not a filter")
    params = BloomParams(log2_m, num_hashes)
    bloom = OracleBloom.__new__(OracleBloom)
    bloom.params, bloom._set = params, None
    bloom.slots = np.unpackbits(words.view(np.uint8), bitorder="little")
    return bloom


def sample_ordinals(num_reads: int, sample: int) -> np.ndarray:
    """Every floor(n/S)-th ordinal, S of them (all reads if fewer)."""
    if sample >= num_reads:
        return np.arange(num_reads, dtype=np.int64)
    return np.arange(sample, dtype=np.int64) * (num_reads // sample)


def read_sample(in_path: str, out_path: str, ordinals: np.ndarray,
                max_len: int, interleaved: bool) -> dict:
    """One pass over a FASTQ input and the run's output of it, in chunks:
    the sample's rows (codes, quals, mask, rgs, seconds: the run's pairing
    rule; padded to `max_len`), the qualities the run wrote for them, and
    the bases the oracle's skip rule counts over every read."""
    from kbbq_tpu_torch.io.fastq import extract_padded_arrays
    from kbbq_tpu_torch.io.stream import iter_fastq_chunks
    from kbbq_tpu_torch.oracle import compute_skips
    parts, outs, usable, s = [], [], 0, 0
    for fq, fo in zip(iter_fastq_chunks(in_path), iter_fastq_chunks(out_path)):
        codes, quals, mask, _ = extract_padded_arrays(fq, max_len)
        e = s + fq.num_reads
        usable += int(((~compute_skips(codes, quals)) & mask).sum())
        sel = ordinals[(ordinals >= s) & (ordinals < e)] - s
        if sel.size:
            sec = ((s + sel) % 2 == 1 if interleaved
                   else fq.seconds_mask()[sel])
            parts.append((codes[sel], quals[sel], mask[sel], sec))
            outs.append(extract_padded_arrays(fo, max_len)[1][sel])
        s = e
    if not parts:
        raise ValueError("no read of the sample is in the input")
    codes, quals, mask, seconds = (np.concatenate(x) for x in zip(*parts))
    return {"codes": codes, "quals": quals, "mask": mask,
            "rgs": np.zeros(codes.shape[0], np.int64), "seconds": seconds,
            "ordinals": ordinals[:codes.shape[0]], "out_quals":
            np.concatenate(outs), "usable_bases": usable, "num_reads": s}


def oracle_spot(sample: dict, words_a, words_b, tables, recal: np.ndarray,
                usable_bases: int, config, total_bases: int,
                device=None) -> dict:
    """The checks of the module docstring on `sample` (``read_sample``'s
    rows: codes, quals, mask, rgs, seconds, global ordinals, out_quals)
    against the run's filters A and B (packed words), its covariate
    `tables`, Q' table `recal`, and `usable_bases` (the oracle's count over
    every read) -> each check's mismatch count and the sample's figures.
    The card's side (trust, walk, histogram) runs on `device` (None: the
    card; "cpu": the plain versions)."""
    import torch

    from kbbq_tpu_torch import resolve_device
    from kbbq_tpu_torch.oracle import (CovariateTables, accumulate_read,
                                       alpha_threshold, build_recal_table,
                                       canonical_kmers, coverage_thresholds,
                                       infer_read_errors, sample_hash,
                                       trusted_kmer_mask)
    from kbbq_tpu_torch.oracle.pipeline import gather_read
    from kbbq_tpu_torch.ops.bloom import bloom_query_words
    from kbbq_tpu_torch.ops.covariate import (accumulate_covariates,
                                              new_covariate_state)
    from kbbq_tpu_torch.ops.hash_cache import hash_windows
    from kbbq_tpu_torch.ops.inference import infer_errors
    from kbbq_tpu_torch.ops.trusted import trusted_from_cache

    dev = resolve_device(device)
    k, h = config.k, config.num_hashes
    alpha, _ = config.resolve_alpha(int(total_bases))
    thresh = alpha_threshold(alpha)
    codes, quals, mask = sample["codes"], sample["quals"], sample["mask"]
    S, L = codes.shape
    if L != tables.max_len:
        raise ValueError(f"the sample is padded to {L}, the tables to "
                         f"{tables.max_len}")
    lens = mask.sum(axis=1)

    # ---- the card's side: trust, walk and histogram of the sample's rows
    t0 = time.time()
    tens = {n: torch.from_numpy(np.ascontiguousarray(sample[n])).to(dev)
            for n in ("codes", "quals", "mask", "rgs", "seconds")}
    fa, fb = (w.to(dev) if isinstance(w, torch.Tensor) else
              torch.from_numpy(np.array(w).view(np.int32)).to(dev)
              for w in (words_a, words_b))
    h1, word = hash_windows(tens["codes"], k, h)
    t_table = torch.from_numpy(
        coverage_thresholds(alpha, k).astype(np.int32)).to(dev)
    trust_dev = trusted_from_cache(fa, h1, word, t_table, k,
                                   config.trust_threshold).cpu().numpy()
    err_t = infer_errors(fb, tens["codes"], k, h, config.ext_cap,
                         trusted0=bloom_query_words(fb, h1, word))
    cov = new_covariate_state(tables.num_rg, L, dev)
    accumulate_covariates(cov, tens["codes"], tens["quals"], tens["mask"],
                          tens["rgs"], tens["seconds"], err_t)
    err_dev = err_t.cpu().numpy()
    cov = {n: v.cpu().numpy() for n, v in cov.items()}
    del tens, fa, fb, h1, word, err_t
    device_s = time.time() - t0

    # ---- the oracle's side, read by read
    t0 = time.time()
    bloom_a = unpacked_bloom(words_a, h)
    bloom_b = unpacked_bloom(words_b, h)
    unpack_s = time.time() - t0
    t0 = time.time()
    mine = CovariateTables(tables.num_rg, L)
    out = dict.fromkeys(CHECKS, 0)
    marked = trusted = 0
    for i in range(S):
        n = int(lens[i])
        c, q = codes[i, :n], quals[i, :n]
        rg, second = int(sample["rgs"][i]), bool(sample["seconds"][i])
        hi, lo, valid = canonical_kmers(c, k)
        offs = np.arange(hi.size, dtype=np.uint32)
        keep = valid & (sample_hash(np.uint32(sample["ordinals"][i]), offs)
                        <= thresh)
        out["pass1_absent_from_a"] += int(
            (~bloom_a.query(hi[keep], lo[keep])).sum())
        tr = trusted_kmer_mask(c, k, bloom_a, alpha, config.trust_threshold)
        row = trust_dev[i]
        if not (np.array_equal(row[:tr.size], tr) and not row[tr.size:].any()):
            out["pass2_trust_mismatched_reads"] += 1
        out["pass2_trusted_absent_from_b"] += int(
            (~bloom_b.query(hi[tr], lo[tr])).sum())
        err = infer_read_errors(c, k, bloom_b, config.ext_cap)
        if not (np.array_equal(err_dev[i, :n], err)
                and not err_dev[i, n:].any()):
            out["pass3_mismatched_reads"] += 1
        accumulate_read(mine, c, q, err, rg, second)
        out["pass4_mismatched_bases"] += int(
            (gather_read(recal, c, q, rg, second)
             != sample["out_quals"][i, :n]).sum())
        marked += int(err.sum())
        trusted += int(tr.sum())
    out["covariate_mismatched_cells"] = sum(
        int((getattr(mine, n) != cov[n]).sum()) for n in cov)
    out["table_total_difference"] = abs(int(tables.cyc_total.sum())
                                        - int(usable_bases))
    out["delta_mismatched_cells"] = int(
        (build_recal_table(tables) != np.asarray(recal)).sum())
    return {**out, "sample": S, "first_ordinal": int(sample["ordinals"][0]),
            "last_ordinal": int(sample["ordinals"][-1]),
            "trusted_windows": trusted, "bases_marked": marked,
            "reads_with_errors": int(err_dev.any(axis=1).sum()),
            "log2_m_a": bloom_a.params.log2_m,
            "log2_m_b": bloom_b.params.log2_m,
            "device_s": device_s, "unpack_s": unpack_s,
            "oracle_s": time.time() - t0}


def check(result: dict) -> None:
    """Raise when any check of ``oracle_spot`` counted a mismatch."""
    bad = {n: result[n] for n in CHECKS if result[n]}
    if bad:
        raise AssertionError(f"the run differs from the oracle: {bad}")


def spot_fastq(in_path: str, config, sample: int = SAMPLE,
               interleaved: bool = False, device=None,
               tmp: str | None = None) -> dict:
    """Recalibrate one FASTQ with the streamed engine (a checkpoint keeps
    its filters and tables, ``keep_results`` its Q' table), then
    ``oracle_spot`` on `sample` reads spread over the file."""
    from kbbq_tpu_torch.pipeline import recalibrate_fastq_streaming
    from kbbq_tpu_torch.pipeline import stream_resident
    from kbbq_tpu_torch.state.checkpoint import Checkpoint

    own = tmp is None
    tmp = tmp or tempfile.mkdtemp(prefix="kbbq_spot_")
    try:
        out_path, ck = os.path.join(tmp, "out.fq"), os.path.join(tmp, "ck")
        t0 = time.time()
        with keep_results(stream_resident, "build_recal_table") as recal:
            info = recalibrate_fastq_streaming(
                in_path, out_path, config, checkpoint_dir=ck,
                interleaved=interleaved, device=device)
        run_s = time.time() - t0
        _log(f"streamed run: {run_s:.1f} s")
        ckpt = Checkpoint(ck)
        tables = ckpt.load_covariates()
        n, bases = info["num_reads"], info["total_bases"]
        t0 = time.time()
        rows = read_sample(in_path, out_path, sample_ordinals(n, sample),
                           tables.max_len, interleaved)
        read_s = time.time() - t0
        res = oracle_spot(rows, ckpt.load_array("rows_a"),
                          ckpt.load_array("rows_b"), tables, recal[-1],
                          rows["usable_bases"], config, bases, device)
    finally:
        if own:
            shutil.rmtree(tmp, ignore_errors=True)
    return {**res, "num_reads": n, "run_s": run_s, "read_s": read_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input", help="a FASTQ file")
    ap.add_argument("-k", type=int, default=32)
    ap.add_argument("-c", "--coverage", type=float, default=None)
    ap.add_argument("--interleaved", action="store_true")
    ap.add_argument("--sample", type=int, default=SAMPLE)
    args = ap.parse_args(argv)
    from kbbq_tpu_torch.pipeline import RecalConfig
    res = spot_fastq(args.input, RecalConfig(k=args.k,
                                             coverage=args.coverage),
                     args.sample, args.interleaved)
    print(json.dumps(res), flush=True)
    check(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())

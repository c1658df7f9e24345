"""The yardstick of the kernel metrics: the card's peaks and the least time
each pass of the recalibration needs on it.

The least time counts the work the passes need, not what a kernel issues:
each input byte read once, each output byte written once, and the integer
operations of the specification a window.  The counts are copies of the
arithmetic the program's smoke script used when the benchmark was written
(``hash_ops``, ``TRUST_RULE_OPS``, ``bound``); the shapes and the counts of
sampled, trusted and marked windows come from the benchmark's reference.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: the device memory rate, and 132 SMs each
# issuing 64 32-bit integer operations a clock at the 1.98 GHz boost clock
# (the passes do integer work only)
PEAK_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
# fmix32: three xor-shifts (a shift and a xor each) and two multiplies
FMIX32_OPS = 8
# the coverage rule a window: hit and valid votes, per base the hit and
# valid windows over it, t(x) and its compare, the covered vote, per window
# its covered bases, the compare with the threshold and the validity
TRUST_RULE_OPS = 2 + 6 + 2 + 1 + 3 + 2
# the walk: every window outside the initial trust rolled once, every
# marked base tried with three candidates of at least one probe each
WALK_ROLL_OPS = 12
WALK_PROBE_OPS = 90
# rows of a chunk of the walk
WALK_CHUNK_ROWS = 65536


def hash_ops(k: int, num_hashes: int, sample: bool = False,
             insert: bool = False) -> int:
    """Integer operations a window of the specification's hash: the forward
    k-mer and its reverse complement cut from packed strands, the canonical
    pick, validity, the block and probe hashes (four fmix32, four xors),
    the probe word and the zero word of an invalid window; sampling adds
    the ordinal's mix, a fifth fmix32, the threshold test and the validity;
    the insert its block index."""
    words = 1 if k <= 16 else 2
    ops = 2 * words + 2 * words + 2 + 4 * FMIX32_OPS + 4 + 3 * num_hashes + 1
    if sample:
        ops += 2 + FMIX32_OPS + 2
    if insert:
        ops += 1
    return ops


def bound_s(bytes_moved: float, ops: float) -> float:
    """Least seconds: the larger of bytes over the memory rate and integer
    operations over the integer rate."""
    return max(bytes_moved / PEAK_BYTES_PER_S, ops / INT_OPS_PER_S)


def passes_least_s(c: dict) -> dict:
    """Least seconds of each pass of one recalibration from the reference's
    counts `c`: pass 1 hashes every window, samples and inserts into filter
    A; pass 2 probes A and applies the coverage rule; filter B is built from
    the trusted windows; pass 3 probes B and walks."""
    N, L, k, h = c["reads"], c["read_len"], c["k"], c["num_hashes"]
    nwin = c["windows"]
    n = max(L - k + 1, 0)
    fa, fb = (1 << c["log2_m_a"]) // 8, (1 << c["log2_m_b"]) // 8
    walk = sum(
        bound_s(rows * (L + n + L) + min(fb, marks * 3 * 4),
                outside * WALK_ROLL_OPS + marks * 3 * WALK_PROBE_OPS)
        for rows, marks, outside in zip(c["rows_by_chunk"],
                                        c["marks_by_chunk"],
                                        c["outside_by_chunk"]))
    return {
        "hash_build": bound_s(N * L + nwin * 9 + 2 * fa,
                              nwin * hash_ops(k, h, sample=True,
                                              insert=True)),
        "probe_trust": bound_s(nwin * 9 + fa, nwin * (TRUST_RULE_OPS + 2)),
        "build_b": bound_s(nwin * 9 + 2 * fb, nwin * 2),
        "probe_b": bound_s(nwin * 9 + fb, nwin * 4),
        "walk": walk,
    }

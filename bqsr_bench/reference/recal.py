"""The plain reference of the recalibration: the same four passes as the
program, written with plain PyTorch tensor operations (they run on
whatever device the reads are put on) and the float64 delta math in NumPy.

It follows the NumPy specification of the recalibration (the Lighter-style
trust rule and correction walk, the GATK-style covariates and hierarchical
deltas), and imports nothing of the program: its constants, sizing and
math are copies made when the benchmark was written.  Filters are held one
byte a slot, as in the specification, not packed into words as the
program holds them.

``recalibrate`` returns the new qualities and the counts of work that the
benchmark's roofline arithmetic reads (windows, sampled and trusted
windows, marked bases, windows outside the initial trust).  Its two
options give the controls: ``delta_dtype=np.float32`` computes the delta
math a precision lower, ``filter_log2_shift=-1`` holds both filters at half
their stated size.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# the specification's constants
FMIX32_C1 = 0x85EBCA6B
FMIX32_C2 = 0xC2B2AE35
SEED_H1 = 0x9E3779B9
SEED_H2 = 0x85EBCA77
SEED_SAMPLE = 0xC0FFEE01
GOLDEN = 0x9E3779B9
M32 = 0xFFFFFFFF
MIN_LOG2_M = 16
LIGHTER_ALPHA = 7.0
P_FALSE_COVER = 0.01
MAX_Q = 93
NUM_Q = 94
MIN_USABLE_Q = 6
RECAL_MIN_Q = 1
NUM_DINUC = 16
DINUC_INVALID = 16
PRIOR_SIGMA = 0.5
EXT_CAP = 32
BASE_N = 4

# rows of reads a step of every pass
CHUNK_ROWS = 1 << 18


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on int64 tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * FMIX32_C1) & M32
    x = x ^ (x >> 13)
    x = (x * FMIX32_C2) & M32
    return x ^ (x >> 16)


def kmer_lanes(codes: torch.Tensor, k: int):
    """Forward and reverse-complement k-mers of every window, as (hi, lo)
    pairs of int64 (forward big-endian: the window's first base in the top
    bits of its 2k-bit word), and each window's validity (no N)."""
    B, L = codes.shape
    n = L - k + 1
    isn = codes >= BASE_N
    c = torch.where(isn, 0, codes.to(torch.int64))
    comp = 3 - c
    z = torch.zeros((B, n), dtype=torch.int64, device=codes.device)
    fhi, flo, rhi, rlo = z, z.clone(), z.clone(), z.clone()
    for i in range(k):
        sf, sr = 2 * (k - 1 - i), 2 * i
        if sf >= 32:
            fhi |= c[:, i:i + n] << (sf - 32)
        else:
            flo |= c[:, i:i + n] << sf
        if sr >= 32:
            rhi |= comp[:, i:i + n] << (sr - 32)
        else:
            rlo |= comp[:, i:i + n] << sr
    ns = torch.nn.functional.pad(isn.to(torch.int32).cumsum(1), (1, 0))
    valid = (ns[:, k:] - ns[:, :n]) == 0
    return [fhi, flo, rhi, rlo], valid


def canonical(fhi, flo, rhi, rlo):
    """The smaller of the k-mer and its reverse complement, (hi, lo)."""
    fwd = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    return torch.where(fwd, fhi, rhi), torch.where(fwd, flo, rlo)


def hashes(hi, lo):
    """(h1, h2): the block hash and the probe hash of canonical k-mers."""
    h1 = fmix32(lo ^ fmix32(hi ^ SEED_H1))
    h2 = fmix32(hi ^ fmix32(lo ^ SEED_H2))
    return h1, h2


class SlotFilter:
    """A blocked Bloom filter of 2^log2_m slots, one byte a slot: a k-mer's
    probes are the slots block * 32 + rotr(h2, 5 i) mod 32, i < num_hashes,
    with block = h1 mod 2^(log2_m - 5)."""

    def __init__(self, log2_m: int, num_hashes: int, device):
        self.log2_m, self.num_hashes = log2_m, num_hashes
        self.slots = torch.zeros(1 << log2_m, dtype=torch.bool,
                                 device=device)
        s = torch.arange(num_hashes, dtype=torch.int64, device=device) * 5
        self.shift = s & 31

    def positions(self, h1, h2):
        block = h1 & ((1 << (self.log2_m - 5)) - 1)
        h = h2[..., None]
        rot = ((h >> self.shift) | (h << ((32 - self.shift) & 31))) & M32
        return block[..., None] * 32 + (rot & 31)

    def insert(self, h1, h2, keep):
        self.slots[self.positions(h1[keep], h2[keep]).reshape(-1)] = True

    def query(self, h1, h2):
        return self.slots[self.positions(h1, h2)].all(dim=-1)


def query_kmers(filt: SlotFilter, hi, lo):
    return filt.query(*hashes(hi, lo))


def sample_keep(first_row: int, rows: int, n: int, threshold: int, device):
    """Per-occurrence sampling: keep window j of read r when
    fmix32(fmix32(r ^ seed) ^ (j * golden)) <= threshold."""
    r = torch.arange(first_row, first_row + rows, dtype=torch.int64,
                     device=device)[:, None] & M32
    j = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    return fmix32(fmix32(r ^ SEED_SAMPLE) ^ ((j * GOLDEN) & M32)) <= threshold


# -------------------------------------------------------------- sizing

def alpha_of(coverage: float) -> float:
    return min(1.0, LIGHTER_ALPHA / max(coverage, 1.0))


def alpha_threshold(alpha: float) -> int:
    if alpha >= 1.0:
        return M32
    return max(0, min(int(alpha * 4294967296.0) - 1, M32))


def log2_slots(keys: int, bits_per_key: int) -> int:
    slots = max(1, keys) * bits_per_key
    return max(MIN_LOG2_M, math.ceil(math.log2(max(2, slots))))


def filter_sizes(total_kmers: int, alpha: float, coverage: float,
                 bits_a: int, bits_b: int):
    """log2 slots of filter A (sampled) and B (trusted): distinct k-mers
    are estimated as 2 * total / coverage."""
    distinct = max(1, int(2.0 * total_kmers / max(1.0, coverage)))
    n_a = max(1, min(int(alpha * total_kmers), distinct))
    n_b = max(1, min(total_kmers, distinct))
    return log2_slots(n_a, bits_a), log2_slots(n_b, bits_b)


@functools.lru_cache(maxsize=16)
def coverage_thresholds(alpha: float, k: int) -> tuple:
    """t(x), x = 0..k: the least t with P[Binom(x, alpha) >= t] <= 1 %,
    at least 1 (x + 1 where none is)."""
    from scipy.stats import binom
    out = []
    for x in range(k + 1):
        t = x + 1
        for cand in range(0, x + 2):
            if binom.sf(cand - 1, x, alpha) <= P_FALSE_COVER:
                t = cand
                break
        out.append(max(1, t))
    return tuple(out)


# ----------------------------------------------------------- the passes

def window_sum_full(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[i] = sum of x[j], j in [i - k + 1, i] within [0, n):
    [B, n + k - 1]."""
    cs = torch.nn.functional.pad(
        torch.nn.functional.pad(x, (k - 1, k - 1)).cumsum(1), (1, 0))
    return cs[:, k:] - cs[:, :-k]


def window_sum_valid(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[j] = sum of x[j .. j + k - 1]: [B, L - k + 1]."""
    cs = torch.nn.functional.pad(x.cumsum(1), (1, 0))
    return cs[:, k:] - cs[:, :x.shape[1] - k + 1]


def trusted_rule(hits, valid, t_table, k: int, trust: int):
    """A window is trusted when it is valid and at least `trust` of its
    bases are covered; a base is covered when the sampled windows over it
    reach t(number of valid windows over it)."""
    s = window_sum_full(hits.to(torch.int32), k)
    x = window_sum_full(valid.to(torch.int32), k)
    covered = s >= t_table[x.long()]
    return valid & (window_sum_valid(covered.to(torch.int32), k) >= trust)


def longest_runs(trusted: torch.Tensor):
    """(a, b, has): the leftmost longest run of trusted windows of each
    read, first and last index."""
    B, n = trusted.shape
    i = torch.arange(n, dtype=torch.int64, device=trusted.device)[None, :]
    last_false = torch.where(trusted, -1, i).expand(B, n).cummax(1).values
    runs = torch.where(trusted, i - last_false, 0)
    b = (runs * (n + 1) + (n - i)).argmax(1)
    ln = runs.gather(1, b[:, None])[:, 0]
    return b - ln + 1, b, ln > 0


def next_break(teff, valid, x, n):
    i = torch.arange(teff.shape[1], dtype=torch.int64,
                     device=teff.device)[None, :]
    m = valid & ~teff & (i >= x[:, None])
    return torch.where(m, i, n).min(1).values


def prev_break(teff, valid, x):
    i = torch.arange(teff.shape[1], dtype=torch.int64,
                     device=teff.device)[None, :]
    m = valid & ~teff & (i <= x[:, None])
    return torch.where(m, i, -1).max(1).values


def patch(hi, lo, bitpos, val):
    """Set the 2-bit field at bit `bitpos` of the (hi, lo) word to `val`."""
    in_hi = bitpos >= 32
    sh = torch.where(in_hi, bitpos - 32, bitpos)
    m = ~(3 << sh) & M32
    return (torch.where(in_hi, (hi & m) | (val << sh), hi),
            torch.where(in_hi, lo, (lo & m) | (val << sh)))


def walk_direction(query, work, lanes, valid, teff, err, j, k, W, step):
    """The correction walk of every read in one direction, all reads a
    round: at each read's next break (a valid window not trusted) the base
    entering it is marked as an error, and of its three substitutes the one
    that makes the most of the next W windows trusted (ties: the smallest
    code) is written in when it makes at least one; the walk then skips
    those windows."""
    dev = work.device
    n = teff.shape[1]
    done = n if step > 0 else -1
    t = torch.arange(k, dtype=torch.int64, device=dev)
    c3i = torch.arange(3, dtype=torch.int64, device=dev)
    while True:
        rows = torch.nonzero(j != done)[:, 0]
        if rows.numel() == 0:
            return
        ja = j[rows]
        win = ja[:, None] + step * t[None, :]
        inb = (win >= 0) & (win < n)
        winc = win.clamp(0, n - 1)
        r2 = rows[:, None]
        wf_hi, wf_lo = lanes[0][r2, winc], lanes[1][r2, winc]
        wr_hi, wr_lo = lanes[2][r2, winc], lanes[3][r2, winc]
        wvalid = valid[r2, winc] & inb
        p = ja + (k - 1 if step > 0 else 0)
        orig = work[rows, p].to(torch.int64)
        c3 = c3i[None, :] + (c3i[None, :] >= orig[:, None]).to(torch.int64)
        cval = c3[:, :, None]
        d = (p[:, None] - win)[:, None, :]
        pf_hi, pf_lo = patch(wf_hi[:, None], wf_lo[:, None],
                             2 * (k - 1 - d), cval)
        pr_hi, pr_lo = patch(wr_hi[:, None], wr_lo[:, None], 2 * d, 3 - cval)
        chi, clo = canonical(pf_hi, pf_lo, pr_hi, pr_lo)
        q = query(chi, clo) & wvalid[:, None, :]
        ext = q[:, :, :W].to(torch.int64).cumprod(-1).sum(-1)
        bi = (ext * 4 + (2 - c3i)[None, :]).argmax(1)
        best_ext = ext.gather(1, bi[:, None])[:, 0]
        best_c = c3.gather(1, bi[:, None])[:, 0]
        err[rows, p] = True
        cr = torch.nonzero(best_ext >= 1)[:, 0]
        if cr.numel():
            bic = bi[cr]
            sel = inb[cr]
            rr = rows[cr][:, None].expand(-1, k)[sel]
            ww = winc[cr][sel]
            for lane, new in zip(lanes, (pf_hi, pf_lo, pr_hi, pr_lo)):
                lane[rr, ww] = new[cr, bic][sel]
            teff[rr, ww] = q[cr, bic][sel]
            work[rows[cr], p[cr]] = best_c[cr].to(work.dtype)
        x = ja + step * best_ext.clamp(min=1)
        if step > 0:
            j[rows] = next_break(teff[rows], valid[rows], x, n)
        else:
            j[rows] = prev_break(teff[rows], valid[rows], x)


def infer_errors(filt: SlotFilter, codes, lanes, valid, trusted0, k, W):
    """Error mask [B, L]: the walk right from the end of each read's
    longest trusted run and left from its start."""
    B, L = codes.shape
    n = L - k + 1
    err = torch.zeros((B, L), dtype=torch.bool, device=codes.device)
    any_valid = valid.any(1)
    all_tr = (trusted0 | ~valid).all(1)
    a, b, has = longest_runs(trusted0)
    active = any_valid & ~all_tr & has
    work = codes.clone()
    teff = trusted0.clone()

    def query(hi, lo):
        return query_kmers(filt, hi, lo)

    j = next_break(teff, valid, torch.where(active, b + 1, n), n)
    walk_direction(query, work, lanes, valid, teff, err, j, k, W, +1)
    j = prev_break(teff, valid, torch.where(active, a - 1, -1))
    walk_direction(query, work, lanes, valid, teff, err, j, k, W, -1)
    return err


def covariates(codes, quals, seconds):
    """(skip, q, cycle index, dinucleotide) of every base."""
    B, L = codes.shape
    c = codes.to(torch.int64)
    q0 = quals.to(torch.int64)
    skip = (c == BASE_N) | (q0 < MIN_USABLE_Q)
    q = q0.clamp(0, NUM_Q - 1)
    i = torch.arange(L, dtype=torch.int64, device=codes.device)[None, :]
    cyc = i * 2 + seconds.to(torch.int64)[:, None]
    prev = torch.nn.functional.pad(c[:, :-1], (1, 0), value=BASE_N)
    ok = (prev != BASE_N) & (c != BASE_N) & (i > 0)
    din = torch.where(ok, prev * 4 + c, DINUC_INVALID)
    return skip, q, cyc, din


# ---------------------------------------------------------- delta math

def _log10_prior(d, dt):
    d = np.asarray(d, dtype=dt)
    return -(d * d) / dt(2.0 * PRIOR_SIGMA * PRIOR_SIGMA) / dt(np.log(10.0))


def empirical_quality(errors, total, prior, dt=np.float64):
    """argmax over q of log10 prior(q - prior) + log10 Binom(errors | total,
    10^(-q/10)), ties to the smallest q; empty cells take round(prior)."""
    from scipy.special import gammaln
    qs = np.arange(NUM_Q, dtype=dt)
    p = np.clip(np.power(dt(10.0), -qs / dt(10.0)), dt(1e-10),
                dt(1.0) - dt(1e-10)).astype(dt)
    lp, l1mp = np.log10(p).astype(dt), np.log10(dt(1.0) - p).astype(dt)
    e, n, pr = np.broadcast_arrays(np.asarray(errors, dt),
                                   np.asarray(total, dt),
                                   np.asarray(prior, dt))
    out = np.clip(np.round(pr), 0.0, float(MAX_Q)).astype(dt)
    nz = np.flatnonzero(n.ravel() > 0)
    if nz.size:
        ef, nf, pf = e.reshape(-1)[nz], n.reshape(-1)[nz], pr.reshape(-1)[nz]
        one = dt(1.0)
        nck = ((gammaln(nf + one) - gammaln(ef + one)
                - gammaln(nf - ef + one)) / dt(np.log(10.0))).astype(dt)
        ll = nck[:, None] + ef[:, None] * lp + (nf - ef)[:, None] * l1mp
        post = _log10_prior(qs - pf[:, None], dt) + ll
        out.reshape(-1)[nz] = np.argmax(post, axis=-1)
    return out


def recal_table(cyc_total, cyc_errors, din_total, din_errors,
                dt=np.float64) -> np.ndarray:
    """The dense table Q'[rg, q, cycle, dinuc + invalid] (int8): round(q +
    dRG + dQ + dCycle + dDinuc) clamped to [1, 93], each delta the
    empirical quality of its cell against the level above."""
    with np.errstate(divide="ignore", invalid="ignore"):
        qt, qe = cyc_total.sum(2), cyc_errors.sum(2)
        rgt, rge = cyc_total.sum((1, 2)), cyc_errors.sum((1, 2))
        qs = np.arange(NUM_Q, dtype=dt)
        pq = np.power(dt(10.0), -qs / dt(10.0))
        n = qt.sum(1)
        mean_q = np.where(n > 0, dt(-10.0) * np.log10(
            (qt.astype(dt) * pq).sum(1) / np.maximum(n, 1)), 0.0).astype(dt)
        d_rg = np.where(rgt > 0, empirical_quality(rge, rgt, mean_q, dt)
                        - mean_q, 0.0).astype(dt)
        prior_q = (qs[None, :] + d_rg[:, None]).astype(dt)
        d_q = np.where(qt > 0, empirical_quality(qe, qt, prior_q, dt)
                       - prior_q, 0.0).astype(dt)
        prior = (prior_q + d_q)[..., None]
        d_cyc = np.where(cyc_total > 0, empirical_quality(
            cyc_errors, cyc_total, prior, dt) - prior, 0.0).astype(dt)
        d_din = np.where(din_total > 0, empirical_quality(
            din_errors, din_total, prior, dt) - prior, 0.0).astype(dt)
    nrg = cyc_total.shape[0]
    d_din = np.concatenate([d_din, np.zeros((nrg, NUM_Q, 1), dt)], axis=2)
    base = qs[None, :] + d_rg[:, None] + d_q
    out = base[:, :, None, None] + d_cyc[:, :, :, None] + d_din[:, :, None, :]
    return np.clip(np.round(out), RECAL_MIN_Q, MAX_Q).astype(np.int8)


# ------------------------------------------------------------ pipeline

def recalibrate(codes: np.ndarray, quals: np.ndarray, rgs: np.ndarray,
                seconds: np.ndarray, num_rg: int, k: int, coverage: float,
                device, num_hashes: int = 7, sampled_bits_per_key: int = 20,
                trusted_bits_per_key: int = 20, delta_dtype=np.float64,
                filter_log2_shift: int = 0, chunk_rows: int = CHUNK_ROWS):
    """New qualities int8 [N, L] of full-length reads (codes int8 [N, L],
    quals int8 [N, L], rgs [N], seconds bool [N]), and the work counts.
    Row r is sampled as read ordinal r."""
    dev = torch.device(device)
    N, L = codes.shape
    n = L - k + 1
    total_kmers = N * max(n, 0)
    alpha = alpha_of(coverage)
    threshold = alpha_threshold(alpha)
    la, lb = filter_sizes(total_kmers, alpha, coverage,
                          sampled_bits_per_key, trusted_bits_per_key)
    la, lb = la + filter_log2_shift, lb + filter_log2_shift
    t_table = torch.tensor(coverage_thresholds(alpha, k), dtype=torch.int32,
                           device=dev)
    W = min(EXT_CAP, k)
    spans = [(s, min(N, s + chunk_rows)) for s in range(0, N, chunk_rows)]

    def reads(s, e):
        return torch.from_numpy(np.ascontiguousarray(codes[s:e])).to(dev)

    def hashed(c):
        lanes, valid = kmer_lanes(c, k)
        h1, h2 = hashes(*canonical(*lanes))
        return lanes, valid, h1, h2

    counts = {"reads": N, "read_len": L, "k": k, "num_hashes": num_hashes,
              "windows": N * n, "log2_m_a": la, "log2_m_b": lb,
              "sampled": 0, "trusted": 0, "marks_by_chunk": [],
              "outside_by_chunk": [], "rows_by_chunk": []}
    fa = SlotFilter(la, num_hashes, dev)
    for s, e in spans:
        _, valid, h1, h2 = hashed(reads(s, e))
        keep = valid & sample_keep(s, e - s, n, threshold, dev)
        counts["sampled"] += int(keep.sum())
        fa.insert(h1, h2, keep)
    fb = SlotFilter(lb, num_hashes, dev)
    for s, e in spans:
        _, valid, h1, h2 = hashed(reads(s, e))
        tr = trusted_rule(fa.query(h1, h2) & valid, valid, t_table, k, k)
        counts["trusted"] += int(tr.sum())
        fb.insert(h1, h2, tr)
    del fa
    cyc_t = torch.zeros(num_rg * NUM_Q * 2 * L, dtype=torch.int64, device=dev)
    cyc_e = cyc_t.clone()
    din_t = torch.zeros(num_rg * NUM_Q * NUM_DINUC, dtype=torch.int64,
                        device=dev)
    din_e = din_t.clone()
    for s, e in spans:
        c = reads(s, e)
        lanes, valid, h1, h2 = hashed(c)
        tr0 = fb.query(h1, h2) & valid
        del h1, h2
        err = infer_errors(fb, c, lanes, valid, tr0, k, W)
        # the counts of each 65,536-row chunk, as the program's walk takes them
        for cs in range(0, e - s, 65536):
            ce = min(e - s, cs + 65536)
            counts["rows_by_chunk"].append(ce - cs)
            counts["marks_by_chunk"].append(int(err[cs:ce].sum()))
            counts["outside_by_chunk"].append(int((~tr0[cs:ce]).sum()))
        skip, q, cyc, din = covariates(
            c, torch.from_numpy(np.ascontiguousarray(quals[s:e])).to(dev),
            torch.from_numpy(np.asarray(seconds[s:e], bool)).to(dev))
        use = ~skip
        bad = err & use
        rg = torch.from_numpy(np.asarray(rgs[s:e], np.int64)).to(dev)
        rgq = rg[:, None] * NUM_Q + q
        flat_c = rgq * (2 * L) + cyc
        cyc_t += torch.bincount(flat_c[use], minlength=cyc_t.numel())
        cyc_e += torch.bincount(flat_c[bad], minlength=cyc_e.numel())
        ok = use & (din != DINUC_INVALID)
        flat_d = rgq * NUM_DINUC + din
        din_t += torch.bincount(flat_d[ok], minlength=din_t.numel())
        din_e += torch.bincount(flat_d[bad & ok], minlength=din_e.numel())
    del fb
    shape_c, shape_d = (num_rg, NUM_Q, 2 * L), (num_rg, NUM_Q, NUM_DINUC)
    table = recal_table(cyc_t.cpu().numpy().reshape(shape_c),
                        cyc_e.cpu().numpy().reshape(shape_c),
                        din_t.cpu().numpy().reshape(shape_d),
                        din_e.cpu().numpy().reshape(shape_d), delta_dtype)
    flat_table = torch.from_numpy(table.reshape(-1)).to(dev)
    out = np.empty((N, L), np.int8)
    for s, e in spans:
        c = reads(s, e)
        qq = torch.from_numpy(np.ascontiguousarray(quals[s:e])).to(dev)
        skip, q, cyc, din = covariates(
            c, qq, torch.from_numpy(np.asarray(seconds[s:e], bool)).to(dev))
        rg = torch.from_numpy(np.asarray(rgs[s:e], np.int64)).to(dev)[:, None]
        flat = ((rg * NUM_Q + q) * (2 * L) + cyc) * (NUM_DINUC + 1) + din
        out[s:e] = torch.where(skip, qq, flat_table[flat]).cpu().numpy()
    counts["marks"] = int(sum(counts["marks_by_chunk"]))
    return out, counts

"""Pass-3 tensor op: batched Lighter-style error inference (D7).

Counterpart of ``kbbq_tpu/ops/inference.py`` and ``ops/pallas_walk.py``;
bit-exact twin of ``oracle/lighter.py::infer_read_errors``.

On the card the whole walk is ONE launch of the ``walk_errors`` kernel: a
block stages a tile of reads in shared memory, and a warp per (read,
direction) that has a break follows the oracle's sequential recurrence
directly, probing the 32 windows of a step at once.  Beside it,
``infer_errors_plain`` is the plain PyTorch version: a
ROUND-BASED batch sweep in the manner of the JAX package's ``_walk_loop``.
Between "breaks" (a valid, untrusted window) the oracle's walk only
advances through windows whose trust is already known, so the sweep keeps
an *effective trust* array [B, n] and handles exactly one break per active
read in each round:

  1. take the k windows that contain the base entering at the break (a
     gather at each read's cursor);
  2. build the 3 substitution candidates by PATCHING the window k-mer
     lanes (the base at window offset d is bit 2(k-1-d) of the forward
     word and bit 2d of the RC word);
  3. ONE batched filter query [A, 3, W] (W = extension cap, D7);
  4. resolve extensions and ties, commit the chosen substitution into the
     lanes and the working sequence, refresh the effective trust of the k
     re-queried windows, jump the cursor to the next break.

The right walk runs from the end of the anchor (the longest trusted run),
the left walk from its start, on the same state: they touch disjoint
windows and bases.  Breaks can only land on valid (N-free) windows, which
subsumes the oracle's explicit N-window skips.
"""

from __future__ import annotations

import torch

from ..constants import DEFAULT_EXT_CAP
from .bloom import _query_rows_w, bloom_query_rows
from .kmers import M32, _canonical_w, _kmer_lanes_w, canonical_kmers_batch


def _longest_run_anchors(trusted: torch.Tensor):
    """Batched longest-True-run (ties -> leftmost): (a, b, has) each [B].

    Matches oracle _longest_true_run.  run[i] = i - (index of the last
    False at or before i); the key below has a unique maximum at the end
    of the leftmost longest run, so argmax needs no tie rule.
    """
    B, n = trusted.shape
    i = torch.arange(n, dtype=torch.int64, device=trusted.device)[None, :]
    last_false = torch.where(trusted, torch.full_like(i, -1), i) \
        .expand(B, n).cummax(dim=1).values
    runs = torch.where(trusted, i - last_false, torch.zeros_like(i))
    b = (runs * (n + 1) + (n - i)).argmax(dim=1)
    ln = runs.gather(1, b[:, None])[:, 0]
    a = b - ln + 1
    return a, b, ln > 0


def _next_break(teff, valid, x, n):
    """First index i >= x with valid[i] & ~teff[i], else n.  [B] int64."""
    i = torch.arange(teff.shape[1], dtype=torch.int64,
                     device=teff.device)[None, :]
    mask = valid & (~teff) & (i >= x[:, None])
    return torch.where(mask, i, torch.full_like(i, n)).min(dim=1).values


def _prev_break(teff, valid, x):
    """Last index i <= x with valid[i] & ~teff[i], else -1.  [B] int64."""
    i = torch.arange(teff.shape[1], dtype=torch.int64,
                     device=teff.device)[None, :]
    mask = valid & (~teff) & (i <= x[:, None])
    return torch.where(mask, i, torch.full_like(i, -1)).max(dim=1).values


def _patch_lanes(hi, lo, bitpos, val):
    """Set the 2-bit field at global bit `bitpos` (0..2k-2) to `val`.

    hi holds bits 32..2k-1, lo bits 0..31 (k<17: everything in lo).
    Shapes broadcast; all wide int64.
    """
    in_hi = bitpos >= 32
    sh = torch.where(in_hi, bitpos - 32, bitpos)
    m = ~(3 << sh) & M32
    nhi = (hi & m) | (val << sh)
    nlo = (lo & m) | (val << sh)
    return torch.where(in_hi, nhi, hi), torch.where(in_hi, lo, nlo)


def _walk_rounds(packed, work, lanes, valid, teff, err, j, k, W,
                 num_hashes, step):
    """All rounds of one directional walk, updating work / lanes / teff /
    err IN PLACE.  step = +1 walks right (the base entering window j is
    j+k-1), step = -1 walks left (entering base j).  j: [B] cursor at each
    read's first break; n (right) or -1 (left) means done.
    """
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
        win = ja[:, None] + step * t[None, :]               # [A, k]
        inb = (win >= 0) & (win < n)
        winc = win.clamp(0, n - 1)
        r2 = rows[:, None]
        wf_hi, wf_lo = lanes[0][r2, winc], lanes[1][r2, winc]
        wr_hi, wr_lo = lanes[2][r2, winc], lanes[3][r2, winc]
        wvalid = valid[r2, winc] & inb
        p = ja + (k - 1 if step > 0 else 0)
        orig = work[rows, p].to(torch.int64)

        # the 3 non-original candidates in ascending code order
        c3 = c3i[None, :] + (c3i[None, :] >= orig[:, None]).to(torch.int64)
        cval = c3[:, :, None]                               # [A, 3, 1]
        d = (p[:, None] - win)[:, None, :]                  # offset of p
        pf_hi, pf_lo = _patch_lanes(wf_hi[:, None], wf_lo[:, None],
                                    2 * (k - 1 - d), cval)
        pr_hi, pr_lo = _patch_lanes(wr_hi[:, None], wr_lo[:, None],
                                    2 * d, 3 - cval)
        chi, clo = _canonical_w(pf_hi, pf_lo, pr_hi, pr_lo)  # [A, 3, k]

        # extension = leading trusted windows, at most W and inside the read
        q = _query_rows_w(packed, chi[:, :, :W], clo[:, :, :W],
                          num_hashes) & wvalid[:, None, :W]
        ext = q.to(torch.int64).cumprod(dim=-1).sum(dim=-1)  # [A, 3]
        # strict '>' in the oracle: ties go to the smallest code
        bi = (ext * 4 + (2 - c3i)[None, :]).argmax(dim=1)
        best_ext = ext.gather(1, bi[:, None])[:, 0]
        best_c = c3.gather(1, bi[:, None])[:, 0]

        err[rows, p] = True
        cr = torch.nonzero(best_ext >= 1)[:, 0]
        if cr.numel():
            bic = bi[cr]
            q_all = q[cr, bic]                              # [C, W]
            if W < k:
                # windows [W, k) of the CHOSEN sequence get their real trust
                q2 = _query_rows_w(packed, chi[cr, bic][:, W:],
                                   clo[cr, bic][:, W:], num_hashes)
                q_all = torch.cat([q_all, q2 & wvalid[cr][:, W:]], dim=1)
            sel = inb[cr]
            rr = rows[cr][:, None].expand(-1, k)[sel]
            ww = winc[cr][sel]
            for lane, new in zip(lanes, (pf_hi, pf_lo, pr_hi, pr_lo)):
                lane[rr, ww] = new[cr, bic][sel]
            teff[rr, ww] = q_all[sel]
            work[rows[cr], p[cr]] = best_c[cr].to(work.dtype)

        x = ja + step * best_ext.clamp(min=1)
        if step > 0:
            j[rows] = _next_break(teff[rows], valid[rows], x, n)
        else:
            j[rows] = _prev_break(teff[rows], valid[rows], x)


def infer_errors_plain(packed: torch.Tensor, codes: torch.Tensor, k: int,
                       num_hashes: int, ext_cap: int | None = None,
                       trusted0: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Plain PyTorch error inference (round-based; module docstring).
    Runs on whatever device its tensors lie on."""
    B, L = codes.shape
    n = L - k + 1
    err = torch.zeros((B, L), dtype=torch.bool, device=codes.device)
    if n <= 0 or B == 0:
        return err
    W = min(ext_cap if ext_cap is not None else DEFAULT_EXT_CAP, k)

    fhi, flo, rhi, rlo, valid = _kmer_lanes_w(codes, k)
    if trusted0 is None:
        hi, lo = _canonical_w(fhi, flo, rhi, rlo)
        trusted0 = _query_rows_w(packed, hi, lo, num_hashes) & valid
    any_valid = valid.any(dim=1)
    all_tr = (trusted0 | ~valid).all(dim=1)
    a, b, has_anchor = _longest_run_anchors(trusted0)
    active = any_valid & ~all_tr & has_anchor

    lanes = [fhi, flo, rhi, rlo]
    work = codes.clone()
    teff = trusted0.clone()
    n_t = torch.full_like(a, n)
    j0 = _next_break(teff, valid, torch.where(active, b + 1, n_t), n)
    _walk_rounds(packed, work, lanes, valid, teff, err, j0, k, W,
                 num_hashes, +1)
    j0 = _prev_break(teff, valid,
                     torch.where(active, a - 1, torch.full_like(a, -1)))
    _walk_rounds(packed, work, lanes, valid, teff, err, j0, k, W,
                 num_hashes, -1)
    return err


def infer_errors(packed: torch.Tensor, codes: torch.Tensor, k: int,
                 num_hashes: int, ext_cap: int | None = None,
                 trusted0: torch.Tensor | None = None) -> torch.Tensor:
    """Error mask per base for a batch (D7): bool [B, L].

    packed: int32 [m/32] trusted filter; codes: int8 [B, L] (4 = N/pad).
    trusted0: optional precomputed initial trust of every window of the
    original sequence, ``query & valid`` bool [B, n] (callers holding the
    pass-1 hash cache pass the cached word test and skip the re-hash).
    CUDA tensors go through the ``walk_errors`` kernel, CPU tensors
    through ``infer_errors_plain``.
    """
    if not codes.is_cuda:
        return infer_errors_plain(packed, codes, k, num_hashes, ext_cap,
                                  trusted0)
    from .. import kernels
    B, L = codes.shape
    if L - k + 1 <= 0 or B == 0:
        return torch.zeros((B, L), dtype=torch.bool, device=codes.device)
    if trusted0 is None:
        hi, lo, valid = canonical_kmers_batch(codes, k)
        trusted0 = bloom_query_rows(packed, hi, lo, num_hashes) & valid
    W = min(ext_cap if ext_cap is not None else DEFAULT_EXT_CAP, k)
    return kernels.walk_errors(codes, trusted0, packed, k, W, num_hashes)

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

The sweep takes its membership test as a callable (``walk_plain``; the JAX
package's ``query_fn``): ``infer_errors_plain`` passes the local test of a
packed filter.  A hash-space-sharded filter (``parallel/sharded_bloom.py``)
is reached only by an exchange between ranks, so ``infer_errors_sharded``
walks in rounds and lane groups: the ``walk_round`` kernel on the card
(``walk_start``, then per group ``walk_propose``, the exchange and
``walk_resolve``), ``RoundWalkPlain`` (its plain version, the same lists,
groups and pairs) on the CPU.
"""

from __future__ import annotations

import torch

from ..constants import DEFAULT_EXT_CAP
from .bloom import (_probe_word_w, _query_rows_w, bloom_query_rows,
                    bloom_query_words)
from .kmers import (M32, _canonical_w, _kmer_hashes_w, _kmer_lanes_w,
                    canonical_kmers_batch, wide_to_u32)


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


def _walk_rounds(query, work, lanes, valid, teff, err, j, k, W, step):
    """All rounds of one directional walk, updating work / lanes / teff /
    err IN PLACE.  step = +1 walks right (the base entering window j is
    j+k-1), step = -1 walks left (entering base j).  j: [B] cursor at each
    read's first break; n (right) or -1 (left) means done.  query(hi, lo):
    membership of canonical k-mers (wide lanes) -> bool of their shape,
    called once a round.
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

        # all k windows of every candidate in ONE query: the extension
        # reads the first W, the chosen candidate's trust all k
        q = query(chi, clo) & wvalid[:, None, :]
        # extension = leading trusted windows, at most W and inside the read
        ext = q[:, :, :W].to(torch.int64).cumprod(dim=-1).sum(dim=-1)
        # strict '>' in the oracle: ties go to the smallest code
        bi = (ext * 4 + (2 - c3i)[None, :]).argmax(dim=1)
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
            j[rows] = _next_break(teff[rows], valid[rows], x, n)
        else:
            j[rows] = _prev_break(teff[rows], valid[rows], x)


def walk_plain(query, codes: torch.Tensor, k: int, W: int,
               trusted0: torch.Tensor | None = None) -> torch.Tensor:
    """The round-based plain walk (module docstring) with its membership
    test `query(hi, lo)` (canonical k-mers as wide lanes -> bool of their
    shape): the error mask bool [B, L].  trusted0: the initial trust of
    every window, ``query & valid`` bool [B, n]; None asks `query`."""
    B, L = codes.shape
    n = L - k + 1
    err = torch.zeros((B, L), dtype=torch.bool, device=codes.device)
    if n <= 0:
        return err
    fhi, flo, rhi, rlo, valid = _kmer_lanes_w(codes, k)
    if trusted0 is None:
        hi, lo = _canonical_w(fhi, flo, rhi, rlo)
        trusted0 = query(hi, lo) & valid
    any_valid = valid.any(dim=1)
    all_tr = (trusted0 | ~valid).all(dim=1)
    a, b, has_anchor = _longest_run_anchors(trusted0)
    active = any_valid & ~all_tr & has_anchor

    lanes = [fhi, flo, rhi, rlo]
    work = codes.clone()
    teff = trusted0.clone()
    n_t = torch.full_like(a, n)
    j0 = _next_break(teff, valid, torch.where(active, b + 1, n_t), n)
    _walk_rounds(query, work, lanes, valid, teff, err, j0, k, W, +1)
    j0 = _prev_break(teff, valid,
                     torch.where(active, a - 1, torch.full_like(a, -1)))
    _walk_rounds(query, work, lanes, valid, teff, err, j0, k, W, -1)
    return err


def _ext_width(ext_cap: int | None, k: int) -> int:
    return min(ext_cap if ext_cap is not None else DEFAULT_EXT_CAP, k)


def infer_errors_plain(packed: torch.Tensor, codes: torch.Tensor, k: int,
                       num_hashes: int, ext_cap: int | None = None,
                       trusted0: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Plain PyTorch error inference (round-based; module docstring) against
    the packed filter: ``walk_plain`` with its local test.  Runs on
    whatever device its tensors lie on."""
    B, L = codes.shape
    if L - k + 1 <= 0 or B == 0:
        return torch.zeros((B, L), dtype=torch.bool, device=codes.device)
    return walk_plain(lambda hi, lo: _query_rows_w(packed, hi, lo,
                                                   num_hashes),
                      codes, k, _ext_width(ext_cap, k), trusted0)


class RoundWalkPlain:
    """The plain version of kernel ``walk_round`` (``kernels.WalkState``
    and its entry points): the round walk of ``walk_plain`` with both
    directions of a read walking in the same round, lane lists of (read,
    direction) ids, and each round taken in groups of at most `group`
    lanes, whose pairs go out grouped by `owners` owners and whose answers
    come back by position.  A lane whose last break found no candidate is
    FAILING: its next round asks each break among its next k windows with
    that window's own entering base replaced; the breaks before the first
    that has a candidate fail like the last (a mark each), and that one is
    the next round's break.  The marks are ``walk_plain``'s."""

    def __init__(self, codes: torch.Tensor, trusted0: torch.Tensor, k: int,
                 group: int, owners: int = 1):
        B, L = codes.shape
        n = L - k + 1
        self.k, self.n, self.owners = k, n, owners
        self.group = max(1, min(int(group), 2 * B))
        self.err = torch.zeros((B, L), dtype=torch.bool, device=codes.device)
        fhi, flo, rhi, rlo, self.valid = _kmer_lanes_w(codes, k)
        self.lanes = [fhi, flo, rhi, rlo]
        self.work, self.teff = codes.clone(), trusted0.clone()
        a, b, has = _longest_run_anchors(trusted0)
        right = _next_break(self.teff, self.valid, torch.where(has, b + 1, n),
                            n)
        left = _prev_break(self.teff, self.valid, torch.where(has, a - 1, -1))
        # each lane's break on the original strand, n (right) or -1 (left)
        # when done, and whether its last break failed
        self.cur = torch.stack([right, left], 1)
        self.failing = torch.zeros_like(self.cur, dtype=torch.bool)
        ids = torch.arange(2 * B, device=codes.device).view(B, 2)
        self.next = [ids[torch.stack([right < n, left >= 0], 1)]]
        self.current = ids.new_empty(0)
        self.pos = 0
        self.rounds = []
        self.asked = None

    def lanes_by_round(self) -> list:
        return list(self.rounds)

    def propose(self, num_hashes: int, shift: int, bound: int):
        """``kernels.walk_propose``: (row int64 [owners + 1], pairs int32
        [P, 2] grouped by owner) of the next group."""
        if self.pos >= self.current.numel():     # the next round begins
            self.current = (torch.cat(self.next) if self.next
                            else self.current[:0])
            self.next, self.pos = [], 0
            if self.current.numel():
                self.rounds.append(int(self.current.numel()))
        g = self.current[self.pos:self.pos + self.group]
        active = (self.current.numel() - self.pos
                  + sum(int(x.numel()) for x in self.next))
        self.pos += g.numel()
        k, n, D = self.k, self.n, self.owners
        L = self.work.shape[1]
        dev = g.device
        rows, dirs = g // 2, g % 2
        fail = self.failing[rows, dirs]
        step = (1 - 2 * dirs)[:, None]
        ja = self.cur[rows, dirs]
        t = torch.arange(k, dtype=torch.int64, device=dev)
        c3i = torch.arange(3, dtype=torch.int64, device=dev)
        win = ja[:, None] + step * t[None, :]               # [A, k]
        inb = (win >= 0) & (win < n)
        winc = win.clamp(0, n - 1)
        r2 = rows[:, None]
        wf_hi, wf_lo = self.lanes[0][r2, winc], self.lanes[1][r2, winc]
        wr_hi, wr_lo = self.lanes[2][r2, winc], self.lanes[3][r2, winc]
        wvalid = self.valid[r2, winc] & inb
        brk = wvalid & ~self.teff[r2, winc]
        p = ja + (k - 1) * (dirs == 0)
        # the base each window's candidates replace: p, or for a failing
        # lane the window's own entering base; the 3 candidate codes in
        # ascending order
        ent = win + (k - 1) * (dirs == 0)[:, None]
        pb = torch.where(fail[:, None], ent, p[:, None])     # [A, k]
        orig = self.work[r2, pb.clamp(0, L - 1)].to(torch.int64)
        c3 = c3i[None, :, None] + (c3i[None, :, None]
                                   >= orig[:, None, :]).to(torch.int64)
        d = (pb - win)[:, None, :]                 # offset of pb, [A, 1, k]
        pf_hi, pf_lo = _patch_lanes(wf_hi[:, None], wf_lo[:, None],
                                    2 * (k - 1 - d), c3)
        pr_hi, pr_lo = _patch_lanes(wr_hi[:, None], wr_lo[:, None],
                                    2 * d, 3 - c3)
        live = torch.where(fail[:, None], brk, wvalid)
        h1, h2 = _kmer_hashes_w(*_canonical_w(pf_hi, pf_lo, pr_hi, pr_lo))
        word = _probe_word_w(h2, num_hashes) * live[:, None, :]
        h1, word = h1.reshape(-1), word.reshape(-1)
        idx = torch.nonzero(word != 0).view(-1)
        owner = (h1[idx] >> shift) & (D - 1)
        owner, order = torch.sort(owner, stable=True)
        idx = idx[order]
        slot = torch.full_like(h1, -1)
        slot[idx] = torch.arange(idx.numel(), device=dev)
        self.asked = (g, rows, dirs, fail, ja, winc, inb, live, brk, p, ent,
                      c3[:, :, 0], (pf_hi, pf_lo, pr_hi, pr_lo), slot)
        row = torch.cat([torch.bincount(owner, minlength=D),
                         torch.tensor([active], device=dev)])
        pairs = torch.stack([wide_to_u32(h1[idx]), wide_to_u32(word[idx])],
                            1)
        return row, pairs

    def resolve(self, answers: torch.Tensor, W: int, bound: int) -> None:
        """``kernels.walk_resolve``: the group's round from `answers` uint8,
        the word tests of the proposed pairs in their order."""
        (g, rows, dirs, fail, ja, winc, inb, live, brk, p, ent, c3, cands,
         slot) = self.asked
        A, k, n = g.numel(), self.k, self.n
        if A == 0:
            return
        dev = g.device
        c3i = torch.arange(3, dtype=torch.int64, device=dev)
        t = torch.arange(k, dtype=torch.int64, device=dev)
        got = answers[slot.clamp(min=0)].bool() & (slot >= 0)
        q = got.view(A, 3, k) & live[:, None, :]
        # a lane: extension = leading trusted windows, at most W and inside
        # the read; strict '>' in the oracle: ties go to the smallest code
        ext = q[:, :, :W].to(torch.int64).cumprod(dim=-1).sum(dim=-1)
        bi = (ext * 4 + (2 - c3i)[None, :]).argmax(dim=1)
        best_ext = torch.where(fail, 0, ext.gather(1, bi[:, None])[:, 0])
        best_c = c3.gather(1, bi[:, None])[:, 0]
        nf = ~fail
        self.err[rows[nf], p[nf]] = True
        cr = torch.nonzero(best_ext >= 1)[:, 0]
        if cr.numel():
            bic = bi[cr]
            sel = inb[cr]
            rr = rows[cr][:, None].expand(-1, k)[sel]
            ww = winc[cr][sel]
            for lane, new in zip(self.lanes, cands):
                lane[rr, ww] = new[cr, bic][sel]
            self.teff[rr, ww] = q[cr, bic][sel]
            self.work[rows[cr], p[cr]] = best_c[cr].to(self.work.dtype)
        # a failing lane: its breaks before the first with a candidate fail
        fixable = q.any(dim=1) & brk
        has = fixable.any(dim=1)
        first = torch.where(has, fixable.to(torch.int64).argmax(dim=1), k)
        marked = brk & (t[None, :] < first[:, None]) & fail[:, None]
        self.err[rows[:, None].expand(-1, k)[marked], ent[marked]] = True
        still = torch.where(fail, ~has, best_ext < 1)
        skip = torch.where(fail, torch.where(has, first, k),
                           best_ext.clamp(min=1))
        x = ja + (1 - 2 * dirs) * skip
        nxt = ja.clone()
        for d, find in ((0, lambda r, y: _next_break(self.teff[r],
                                                     self.valid[r], y, n)),
                        (1, lambda r, y: _prev_break(self.teff[r],
                                                     self.valid[r], y))):
            m = dirs == d
            if m.any():
                nxt[m] = find(rows[m], x[m])
        self.cur[rows, dirs] = nxt
        self.failing[rows, dirs] = still
        self.next.append(g[torch.where(dirs == 0, nxt < n, nxt >= 0)])


class LocalExchange:
    """The exchange of a round walk against a whole packed filter held
    here: one owner, nothing leaves the process (the form of
    ``parallel.sharded_bloom.ShardedFilter.exchange`` that tests and
    chip_smoke.py hold the walk with).  `groups` counts its calls, `pairs`
    the pairs it tested."""

    owners, shift = 1, 0

    def __init__(self, packed: torch.Tensor):
        self.packed = packed
        self.groups = self.pairs = 0

    def exchange(self, row: torch.Tensor, pairs: torch.Tensor):
        self.groups += 1
        P, active = row.tolist()
        self.pairs += P
        if P == 0 and active == 0:
            return None
        return (bloom_query_words(self.packed, pairs[:P, 0].contiguous(),
                                  pairs[:P, 1].contiguous())
                .view(torch.uint8), active)


def infer_errors_sharded(codes: torch.Tensor, trusted0: torch.Tensor,
                         filt, k: int, num_hashes: int, ext_cap: int | None,
                         group: int, stats: dict | None = None
                         ) -> torch.Tensor:
    """Error mask per base, bool [B, L], against a filter reached only
    through an exchange (``filt``: ``owners``, ``shift`` and
    ``exchange(row, pairs)``, as ``ShardedFilter`` has them): the round walk
    in lane groups of at most `group` lanes.  Per group the rank proposes
    its pairs grouped by owner (``row``: the pairs per owner, then every
    lane it still walks), ``exchange`` agrees on the ranks' rows, has the
    pairs tested by their owners and returns (the answers in the pairs'
    order, this rank's lanes) or None once no rank walks a lane, and the
    rank resolves the group.  Every rank calls it once per walk block, also
    with B == 0.  trusted0: bool [B, L-k+1], the initial trust of every
    window.  `stats` gets ``walk_rounds`` added (the rounds of this block)
    and, where it has the key, each round's lane count appended to
    ``lanes_by_round``.

    CUDA tensors go through the ``walk_round`` kernel, CPU tensors through
    ``RoundWalkPlain``; both give ``infer_errors``' marks.
    """
    B, L = codes.shape
    W = _ext_width(ext_cap, k)
    if L - k + 1 <= 0:
        return torch.zeros((B, L), dtype=torch.bool, device=codes.device)
    if codes.is_cuda:
        from .. import kernels
        st = kernels.walk_start(codes, trusted0, k, group, filt.owners)
    else:
        st = RoundWalkPlain(codes, trusted0, k, group, filt.owners)
    bound = st.group if B else 0
    while True:
        row, pairs = st.propose(num_hashes, filt.shift, bound)
        got = filt.exchange(row, pairs)
        if got is None:
            break
        answers, active = got
        bound = min(st.group, active)
        st.resolve(answers, W, bound)
    if stats is not None:
        lanes = st.lanes_by_round()
        stats["walk_rounds"] += len(lanes)
        if "lanes_by_round" in stats:
            stats["lanes_by_round"] += lanes
    return st.err


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
    return kernels.walk_errors(codes, trusted0, packed, k,
                               _ext_width(ext_cap, k), num_hashes)

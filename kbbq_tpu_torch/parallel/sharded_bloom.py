"""The hash-space-sharded Bloom filters: no rank holds a filter whole.

Counterpart of ``kbbq_tpu/parallel/sharded_bloom.py`` (``build_steps``'
``_route``, ``routed_insert_rows``, ``collective_query``, ``_owner_hits``
and the walk's collective query, and ``ShardedBloomRecalPipeline``'s
parameter bump).  Rank d of D owns the contiguous word range
[d * M32/D, (d+1) * M32/D) of a packed filter of M32 = m/32 words, so each
rank allocates m/(32 D) words of either filter and nothing more:

- D divides M32, a power of two, so D is a power of two and so is the
  shard's word count S.  A window's block is h1 & (M32-1); its owner is
  (h1 >> log2 S) & (D-1) and its word in the owner's shard h1 & (S-1),
  which is what the cached entry points compute when handed the shard (their
  block mask comes from the tensor's length).  The owner's build is
  ``bloom_or_words_into(shard, h1, word, keep)``, its test
  ``bloom_query_words(shard, h1, word)``: the kernels need no offset.
- INSERT: each kept (h1, word) pair travels to its owner, which ORs it into
  its shard.  OR commutes, so order and routing change no bit.
- TEST: each pair with word != 0 travels to its owner, the owner answers
  from its shard, and the answers travel back along the reversed splits to
  the requester, which puts them back in place; word == 0 answers False
  without leaving the rank.
- The exchange: ``all_to_all_single`` of the per-owner counts, then of the
  pairs with exact split sizes, then (a test) of the answers.  One code
  path on NCCL and gloo, with no bucket capacity and no fallback (the
  reference's ``CAP_SLACK`` buckets, all-gather fallback and sort-based
  segmented OR exist for XLA's static shapes).  Long streams go in chunks
  of ``EXCHANGE_CHUNK`` entries, every rank taking part in the same number
  of chunks (an all-reduce of the largest count), so no exchange buffer
  grows with the input.
- WALK: pass 3's walk (``ops/inference.py::infer_errors_sharded``; on the
  card the ``walk_round`` kernel) takes a rank's rows in blocks of
  ``WALK_BLOCK_ROWS`` reads, every rank as many blocks as the busiest, and
  each block's rounds in lane groups of at most EXCHANGE_CHUNK / (3k) lanes
  (3k pairs a lane).  A group is ``exchange``: ONE agreement on the count
  matrix (each rank's row: its pairs per owner, then the lanes it still
  walks; one all-gather, one host read, which gives the splits both ways
  and says when every rank is done), the pairs' ``all_to_all_single`` and
  the answers' back.  The ranks need not be in the same round: an owner
  answers whatever it is asked.
- CHECKPOINTS: rank 0 gathers the shards to its host one at a time
  (``to_host``), so no card holds a whole filter; a rank resuming takes its
  own slice of the saved words (``from_host``), at any power-of-two D.

Every collective here is called by every rank the same number of times:
a rank with nothing to send sends empty splits.  Each exchange adds its
seconds and the bytes this rank sent to the others to ``rank.stats``
(``exchange``, ``exchange_bytes``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..constants import MAX_BLOOM_LOG2

# entries of a stream exchanged at once (8 B each way per pair), and the
# device bytes one chunk's exchange takes at most per entry (indices, owners
# and their sort, the pairs sent and received, the answers)
EXCHANGE_CHUNK = 1 << 22
EXCHANGE_BYTES_PER_ENTRY = 96
# reads a walk takes at once: config 2's 1,533,333 reads are one block on
# one device
WALK_BLOCK_ROWS = 1 << 21


def walk_block_bytes(rows: int, max_len: int, k: int) -> int:
    """Device bytes of the walk state of `rows` reads (``kernels.
    WalkState``: the packed copy, flags, marks, cursors and lane lists)."""
    L = int(max_len)
    return int(rows) * (8 * ((L + 31) // 32 + 1) + max(L - k + 1, 0) + L
                        + 8 + 16)


def check_power_of_two(devices: int) -> None:
    """The layout's refusal: the filter's m/32 words (a power of two) must
    split evenly over the devices.  The reference fails here too, with
    JAX's placement error."""
    if devices < 1 or devices & (devices - 1):
        raise ValueError(
            f"the hash-space-sharded Bloom layout needs a power-of-two "
            f"device count (each filter's m/32 words, a power of two, split "
            f"evenly over the devices): got --devices {devices}")


def sharded_params(config, total_kmers: int, alpha: float, coverage: float,
                   devices: int):
    """(filter A, filter B) ``BloomParams`` of the layout on `devices`
    ranks: the one-device sizes, each raised to 2^(5 + D.bit_length() + 5)
    bits where smaller (``ShardedBloomRecalPipeline``'s bump, which changes
    the filters, and so the output, of a small input), within the layout's
    capacity of 2^MAX_BLOOM_LOG2 bits."""
    from ..oracle.bloom import BloomParams, check_layout_capacity
    from ..oracle.pipeline import bloom_params_for
    check_power_of_two(devices)
    min_log2 = 5 + max(1, devices).bit_length() + 5
    out = []
    for p in bloom_params_for(config, int(total_kmers), alpha, coverage):
        if p.log2_m < min_log2:
            p = BloomParams(min_log2, config.num_hashes)
        check_layout_capacity(p, MAX_BLOOM_LOG2, "hash-space-sharded",
                              "lower the bits per key")
        out.append(p)
    return tuple(out)


def agreed_max(rank, n: int) -> int:
    """The largest `n` over the ranks (an all-reduce)."""
    t = torch.tensor([int(n)], dtype=torch.int64, device=rank.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _sync(rank) -> None:
    if rank.device.type == "cuda":
        torch.cuda.synchronize(rank.device)


class ShardedFilter:
    """One rank's shard of a hash-space-sharded packed filter of 2^log2_m
    bits: ``words`` int32 [m/32/D] on the rank's device, the global words
    [rank * S, (rank+1) * S)."""

    def __init__(self, rank, log2_m: int, words: torch.Tensor | None = None):
        D = rank.world
        check_power_of_two(D)
        m32 = 1 << (int(log2_m) - 5)
        if m32 % D:
            raise ValueError(f"a filter of {m32} words does not split over "
                             f"{D} ranks")
        self.rank = rank
        self.log2_m = int(log2_m)
        self.shard_words = m32 // D
        self.shift = self.shard_words.bit_length() - 1
        if words is None:
            words = torch.zeros(self.shard_words, dtype=torch.int32,
                                device=rank.device)
        elif tuple(words.shape) != (self.shard_words,):
            raise ValueError(f"a shard holds {self.shard_words} words")
        self.words = words

    # ------------------------------------------------------------ exchange
    def _owners(self, h1: torch.Tensor) -> torch.Tensor:
        return (((h1.to(torch.int64) & 0xFFFFFFFF) >> self.shift)
                & (self.rank.world - 1))

    def _route(self, h1: torch.Tensor, word: torch.Tensor,
               sel: torch.Tensor):
        """Send the selected entries of the flat (h1, word) chunk to their
        owners: (their indices in owner order, the counts sent to and
        received from each rank, the received pairs int32 [R, 2])."""
        idx = torch.nonzero(sel).view(-1)
        own, order = torch.sort(self._owners(h1[idx]), stable=True)
        idx = idx[order]
        send = torch.bincount(own, minlength=self.rank.world)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        sc, rc = send.tolist(), recv.tolist()
        pairs = torch.stack([h1[idx], word[idx]], 1)
        got = pairs.new_empty((sum(rc), 2))
        dist.all_to_all_single(got, pairs, rc, sc)
        return idx, sc, rc, got

    def _account(self, t0: float, sent: int) -> None:
        """Add an exchange's seconds (its own: the clock starts once the
        rank's queued work is done) and the bytes this rank sent to the
        other ranks."""
        _sync(self.rank)
        self.rank.stats["exchange"] += time.time() - t0
        self.rank.stats["exchange_bytes"] += sent

    def _chunks(self, numel: int):
        """[s, e) of each chunk this rank takes part in (the same count on
        every rank; a rank past its end gets empty chunks)."""
        count = agreed_max(self.rank, -(-numel // EXCHANGE_CHUNK))
        for c in range(count):
            s = min(numel, c * EXCHANGE_CHUNK)
            yield s, min(numel, s + EXCHANGE_CHUNK)

    def insert(self, h1: torch.Tensor, word: torch.Tensor,
               keep: torch.Tensor) -> None:
        """OR every kept window's word into its owner's shard: h1, word
        int32 patterns and keep bool, of one shape, on the rank's device."""
        from ..ops.bloom import bloom_or_words_into
        h1, word, keep = (t.reshape(-1) for t in (h1, word, keep))
        me = self.rank.rank
        for s, e in self._chunks(h1.numel()):
            _sync(self.rank)
            t0 = time.time()
            _, sc, _, got = self._route(h1[s:e], word[s:e], keep[s:e])
            self._account(t0, 8 * (sum(sc) - sc[me]))
            bloom_or_words_into(self.words, got[:, 0].contiguous(),
                                got[:, 1].contiguous(),
                                torch.ones(got.shape[0], dtype=torch.bool,
                                           device=got.device))

    def test(self, h1: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
        """The collective word test: ``(filter[h1 & mask] & word) == word
        and word != 0`` for every entry, each answered by its owner -> bool
        of the shape of h1."""
        from ..ops.bloom import bloom_query_words
        shape = h1.shape
        h1, word = h1.reshape(-1), word.reshape(-1)
        out = torch.zeros(h1.numel(), dtype=torch.bool, device=h1.device)
        me = self.rank.rank
        for s, e in self._chunks(h1.numel()):
            _sync(self.rank)
            t0 = time.time()
            idx, sc, rc, got = self._route(h1[s:e], word[s:e],
                                           word[s:e] != 0)
            ans = bloom_query_words(self.words, got[:, 0].contiguous(),
                                    got[:, 1].contiguous())
            back = torch.empty(sum(sc), dtype=torch.uint8, device=h1.device)
            dist.all_to_all_single(back, ans.to(torch.uint8), sc, rc)
            out[s + idx] = back.bool()
            # pairs out, 8 B each, and the answers back, a byte each
            self._account(t0, 8 * (sum(sc) - sc[me]) + sum(rc) - rc[me])
        return out.view(shape)

    # ---------------------------------------------------------------- walk
    @property
    def owners(self) -> int:
        return self.rank.world

    def exchange(self, row: torch.Tensor, pairs: torch.Tensor):
        """One lane group of the walk: the ranks' rows (int64 [D + 1]: the
        pairs for each owner, then the lanes the rank still walks) gathered
        into the count matrix and read once; the first sum(row[:D]) pairs
        (int32 [., 2], grouped by owner) to their owners, their word tests,
        the answers back.  -> (the answers uint8, in the pairs' order; this
        rank's lanes), or None when the matrix is 0 (no rank walks a lane).
        Three collectives; the walk's last group, which ends it, only the
        agreement."""
        D, me = self.rank.world, self.rank.rank
        stats = self.rank.stats
        t0 = time.time()
        rows = [torch.empty_like(row) for _ in range(D)]
        # the list form, as parallel/merge.py: all_gather_into_tensor is
        # deprecated in newer torch, and its successor is missing from
        # older releases
        dist.all_gather(rows, row)
        M = torch.stack(rows).tolist()
        stats["walk_groups"] += 1
        stats["walk_collectives"] += 1
        if not any(map(any, M)):
            stats["exchange"] += time.time() - t0
            return None
        from ..ops.bloom import bloom_query_words
        sc, rc = M[me][:D], [r[me] for r in M]
        got = pairs.new_empty((sum(rc), 2))
        dist.all_to_all_single(got, pairs[:sum(sc)], rc, sc)
        ans = bloom_query_words(self.words, got[:, 0].contiguous(),
                                got[:, 1].contiguous())
        back = torch.empty(sum(sc), dtype=torch.uint8, device=row.device)
        dist.all_to_all_single(back, ans.view(torch.uint8), sc, rc)
        stats["walk_collectives"] += 2
        # pairs out, 8 B each, and the answers back, a byte each; the
        # seconds are the host's (no wait is added to take them)
        stats["exchange_bytes"] += 8 * (sum(sc) - sc[me]) + sum(rc) - rc[me]
        stats["exchange"] += time.time() - t0
        return back, M[me][D]

    def walk(self, codes: torch.Tensor, trusted0: torch.Tensor, k: int,
             num_hashes: int, ext_cap: int | None = None) -> torch.Tensor:
        """Pass 3's walk of one block of rows, `codes` int8 [B, L] (B may be
        0), against this filter -> the error mask bool [B, L]; every rank
        calls it for the same number of blocks."""
        from ..ops.inference import infer_errors_sharded
        return infer_errors_sharded(
            codes, trusted0, self, k, num_hashes, ext_cap,
            group=max(1, EXCHANGE_CHUNK // (3 * k)), stats=self.rank.stats)

    def walk_blocks(self, codes: torch.Tensor, trusted0: torch.Tensor,
                    k: int, num_hashes: int, ext_cap: int | None = None):
        """(start, end, error mask) of each walk block of the rank's rows,
        ``WALK_BLOCK_ROWS`` at a time; every rank walks as many blocks as
        the busiest (an all-reduce), a rank past its rows empty ones."""
        N = codes.shape[0]
        for b in range(agreed_max(self.rank, -(-N // WALK_BLOCK_ROWS))):
            s = min(N, b * WALK_BLOCK_ROWS)
            e = min(N, s + WALK_BLOCK_ROWS)
            yield s, e, self.walk(codes[s:e], trusted0[s:e], k, num_hashes,
                                  ext_cap)

    # --------------------------------------------------------- host copies
    def to_host(self) -> np.ndarray | None:
        """The whole filter, uint32 [m/32], on rank 0's host (None on the
        other ranks): each rank's shard in turn goes to rank 0 and straight
        on to its slice of the host array, so no card holds two shards."""
        from ..state.convert import bloom_to_numpy
        r, D, S = self.rank.rank, self.rank.world, self.shard_words
        full = np.empty(S * D, dtype=np.uint32) if r == 0 else None
        if r == 0:
            full[:S] = bloom_to_numpy(self.words)
            buf = torch.empty_like(self.words) if D > 1 else None
            for src in range(1, D):
                dist.recv(buf, src)
                full[src * S:(src + 1) * S] = bloom_to_numpy(buf)
        else:
            dist.send(self.words, 0)
        return full

    @classmethod
    def from_host(cls, rank, rows: np.ndarray) -> "ShardedFilter":
        """This rank's shard of a whole filter saved as uint32 [m/32] (a
        checkpoint written at any power-of-two rank count); the filter's
        size is the saved one."""
        m32 = int(rows.shape[0])
        if rows.ndim != 1 or m32 < 1 or m32 & (m32 - 1):
            raise ValueError("a saved filter is 1-D, a power-of-two words")
        S = m32 // rank.world
        part = np.ascontiguousarray(rows[rank.rank * S:(rank.rank + 1) * S],
                                    dtype=np.uint32)
        return cls(rank, (m32 * 32).bit_length() - 1,
                   torch.from_numpy(part.view(np.int32).copy())
                   .to(rank.device))


__all__ = ["EXCHANGE_BYTES_PER_ENTRY", "EXCHANGE_CHUNK", "ShardedFilter",
           "WALK_BLOCK_ROWS", "agreed_max", "check_power_of_two",
           "sharded_params", "walk_block_bytes"]

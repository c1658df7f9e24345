"""Functions that tests/test_torch_parallel.py runs on every rank of a
group (``kbbq_tpu_torch.parallel.mesh.launch`` pickles them by name, so
they live in a module the spawned processes can import).  Each takes the
rank first; they import only the port and torch."""

import numpy as np
import torch


def merges(rank, words_by_rank: list, cov_by_rank: list, recal):
    """or_merge of each rank's word arrays, sum_merge of its covariate
    tables, broadcast_table of rank 0's table; one count of each kernel
    entry point per rank, as a wrapper would add it."""
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.parallel.merge import (broadcast_table, or_merge,
                                               sum_merge)
    ors = [or_merge(rank, torch.from_numpy(w[rank.rank]).to(rank.device))
           .cpu().numpy() for w in words_by_rank]
    cov = {n: torch.from_numpy(a[rank.rank]).to(rank.device)
           for n, a in cov_by_rank.items()}
    sum_merge(rank, cov)
    table = broadcast_table(rank, recal if rank.rank == 0 else None,
                            recal.shape[0], recal.shape[2] // 2)
    for entry, kernel in kernels.ENTRY_KERNEL.items():
        kernels._count(kernel, entry)
    return {"or": ors, "cov": {n: t.cpu().numpy() for n, t in cov.items()},
            "table": table, "rank": rank.rank, "world": rank.world,
            "backend": rank.backend}


def fail_on_rank(rank, bad: int):
    """Raise on rank `bad`; the others wait in a collective it never
    joins."""
    import torch.distributed as dist
    if rank.rank == bad:
        raise ValueError(f"rank {bad} failed on purpose")
    dist.barrier()
    return np.int64(rank.rank)


def sharded_filter(rank, codes, splits, k: int, num_hashes: int,
                   threshold: int, log2_m: int, chunk: int,
                   walk_rows: int = 1 << 21):
    """One hash-space-sharded filter built from every rank's rows
    [splits[r], splits[r+1]) (a rank may have none), with exchanges of at
    most `chunk` entries (walk lane groups of chunk // (3k) lanes): the
    words this rank holds, the whole filter gathered on rank 0, the
    collective word test of the rank's windows, the walk of its rows
    against the filter in blocks of `walk_rows` reads, and the rank's
    stats."""
    from kbbq_tpu_torch.ops.hash_cache import hash_keep
    from kbbq_tpu_torch.parallel import sharded_bloom
    sharded_bloom.EXCHANGE_CHUNK = chunk
    sharded_bloom.WALK_BLOCK_ROWS = walk_rows
    s, e = splits[rank.rank], splits[rank.rank + 1]
    c = torch.from_numpy(codes[s:e]).to(rank.device)
    h1, word, keep = hash_keep(c, s, k, num_hashes, threshold)
    filt = sharded_bloom.ShardedFilter(rank, log2_m)
    filt.insert(h1, word, keep)
    hits = filt.test(h1, word)
    err = torch.zeros(c.shape, dtype=torch.bool)
    for bs, be, block in filt.walk_blocks(c, hits, k, num_hashes):
        err[bs:be] = block
    return {"words": int(filt.words.numel()), "whole": filt.to_host(),
            "hits": hits.cpu().numpy(), "err": err.numpy(),
            "exchange_bytes": rank.stats["exchange_bytes"],
            "stats": dict(rank.stats)}


def with_walk(rank, shared, walk_rows: int, chunk: int, body, *args):
    """``body(rank, shared, *args)``, a rank function of the port's
    ``parallel`` package, with walk blocks of `walk_rows` reads and
    exchanges of `chunk` entries (walk lane groups of chunk // (3k))."""
    from kbbq_tpu_torch.parallel import sharded_bloom
    sharded_bloom.WALK_BLOCK_ROWS = walk_rows
    sharded_bloom.EXCHANGE_CHUNK = chunk
    return body(rank, shared, *args)


def warnings_as_errors(rank, body, *args):
    """``body(rank, *args)`` with torch's deprecation warnings
    (``FutureWarning``, ``DeprecationWarning``) raised as errors in this
    rank."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error", FutureWarning)
        warnings.simplefilter("error", DeprecationWarning)
        return body(rank, *args)

"""The group of ranks: one process per device over ``torch.distributed``.

Counterpart of ``kbbq_tpu/parallel/mesh.py::make_mesh``.  Where the JAX
package shards one program over a device mesh, the port runs one process
per device, each a rank of a ``torch.distributed`` group: NCCL on cards
(rank r owns ``cuda:r``), gloo on the CPU (``device="cpu"``, what the tests
run).  ``launch`` starts the ranks with the spawn start method (CUDA does
not survive ``fork``), runs a function on each and returns what each
returned, rank 0 first.  The caller holds no process group and no CUDA
context of its own for it; it holds the group's store (``TCPStore``),
bound before any rank starts on a port the system picks.

The reads axis is the only one: rank r takes the contiguous rows
``row_range(N, D, r)`` (the resident route) or every D-th window (the
windowed route).  Sampling keys on the global read ordinal, so any split
gives the same filters (DECISIONS D5).

Several hosts (``Hosts``, ``parallel/multihost.py``): every host process
runs ``launch`` with the same coordinator, and its L local ranks join ONE
group of H x L ranks, host h's local rank r as global rank h * L + r, the
group's store at the coordinator's address: host 0's process binds it at
its first launch and keeps it, and each launch keys its group under a
prefix of its own, so the launches of one set of host processes follow one
another on one coordinator.  A host with one local rank runs it in its own
process instead of spawning one.

Arrays reach the ranks through memory-mapped files in a temporary
directory (``SharedArrays``), and the output rows come back the same way:
a file needs no ``/dev/shm`` capacity, which a container may hold small,
and pages it through the host's page cache like shared memory.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def available_devices(device_type: str) -> int:
    """Cards on this host (``cuda``), or the CPUs this process may run on."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return len(os.sched_getaffinity(0))


def check_devices(devices: int, device_type: str) -> None:
    """The reference's refusal of more devices than there are."""
    avail = available_devices(device_type)
    if devices > avail:
        raise ValueError(f"--devices {devices} requested but only {avail} "
                         f"device(s) available")


def row_range(n: int, world: int, rank: int) -> tuple[int, int]:
    """Rank `rank`'s contiguous share [s, e) of `n` rows."""
    return n * rank // world, n * (rank + 1) // world


@dataclasses.dataclass
class Hosts:
    """A group that spans host processes: the coordinator's ``host:port``
    (the group's store, bound by host 0; None for one host, whose store
    ``launch`` binds), the host count and this host's index."""

    coordinator: str | None
    count: int
    index: int


@dataclasses.dataclass
class Rank:
    """What a rank knows of its group: its global rank in a group of
    `world`, and on several hosts its host, the host count and its rank
    among the `local_world` ranks of its host (on one host, the global
    ones).  `stats` collects the merges' seconds and bytes
    (``parallel/merge.py``) and the sharded filters' exchanges'
    (``parallel/sharded_bloom.py``)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    host: int = 0
    hosts: int = 1
    local_rank: int = -1
    local_world: int = 0
    stats: dict = dataclasses.field(
        default_factory=lambda: {"merge": 0.0, "merge_bytes": 0,
                                 "exchange": 0.0, "exchange_bytes": 0,
                                 "walk_rounds": 0, "walk_groups": 0,
                                 "walk_collectives": 0})

    def __post_init__(self):
        if not self.local_world:
            self.local_rank, self.local_world = self.rank, self.world

    @property
    def leader(self) -> int:
        """The global rank of this host's local rank 0."""
        return self.rank - self.local_rank


# how long a rank waits for its group's store and its peers
STORE_TIMEOUT = datetime.timedelta(minutes=30)
# host 0's store of each coordinator ("host:port"): it listens for the life
# of this process, and the launches over it in this process count, so each
# launch's group keys its rendezvous under a prefix of its own, the same on
# every host (each host makes the same calls in the same order)
_COORDINATOR_STORES: dict = {}
_COORDINATOR_LAUNCHES: dict = {}


def _coordinated(hosts: "Hosts", devices: int) -> tuple:
    """The (address, port, key prefix) by which a launch's ranks join the
    group of `hosts` over its coordinator.  Host 0 binds the coordinator's
    store once, in this process, so a host that starts its next launch
    before host 0 has left the last one finds a store that lasts and keys
    of the new group, never the keys or the closing store of the last."""
    import torch.distributed as dist
    addr, port = hosts.coordinator.rsplit(":", 1)
    if hosts.index == 0 and hosts.coordinator not in _COORDINATOR_STORES:
        _COORDINATOR_STORES[hosts.coordinator] = dist.TCPStore(
            addr, int(port), devices * hosts.count, is_master=True,
            wait_for_workers=False, timeout=STORE_TIMEOUT)
    n = _COORDINATOR_LAUNCHES.get(hosts.coordinator, 0)
    _COORDINATOR_LAUNCHES[hosts.coordinator] = n + 1
    return addr, int(port), f"launch{n}"


def _run_rank(local, fn, devices, device_type, init, hosts, args,
              on_error=None) -> dict:
    """Local rank `local` of this host: bind the device, join the group, run
    fn -> its result, when it was ready, the kernel launches it made and
    its stats; the group is left at the end.  `on_error` sees an exception
    of fn before the group is left."""
    import torch.distributed as dist

    from .. import kernels

    host, nhosts = (hosts.index, hosts.count) if hosts else (0, 1)
    world = devices * nhosts
    if device_type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, available_devices("cpu") // devices))
    backend = BACKENDS[device_type]
    addr, port, prefix = init           # the group's store and key prefix
    store = dist.TCPStore(addr, port, world, is_master=False,
                          timeout=STORE_TIMEOUT)
    dist.init_process_group(
        backend, store=dist.PrefixStore(prefix, store), world_size=world,
        rank=host * devices + local,
        device_id=dev if device_type == "cuda" else None)
    try:
        ready = time.time()
        before = dict(kernels.ENTRY_LAUNCHES)
        ctx = Rank(host * devices + local, world, dev, backend, host, nhosts,
                   local, devices)
        try:
            out = fn(ctx, *args)
        except BaseException as e:
            if on_error is not None:
                on_error(e)
            raise
        if device_type == "cuda":
            torch.cuda.synchronize(dev)
        return {"result": out, "ready": ready, "stats": ctx.stats,
                "launches": {e: n - before.get(e, 0)
                             for e, n in kernels.ENTRY_LAUNCHES.items()}}
    finally:
        dist.destroy_process_group()


def _worker(local, fn, devices, device_type, init, hosts, result_dir, args):
    """A spawned local rank: ``_run_rank``, its outcome written into
    `result_dir` (an exception stamped with its time: a rank whose peer
    failed fails later, in a collective)."""

    def failed(e):
        try:
            blob = pickle.dumps((time.time_ns(), e))
        except Exception:
            blob = pickle.dumps((time.time_ns(), RuntimeError(repr(e))))
        path = os.path.join(result_dir, f"{local}.err")
        with open(path + ".tmp", "wb") as f:
            f.write(blob)
        os.replace(path + ".tmp", path)    # whole, or not at all

    res = _run_rank(local, fn, devices, device_type, init, hosts, args,
                    failed)
    with open(os.path.join(result_dir, f"{local}.pkl"), "wb") as f:
        pickle.dump(res, f)


def launch(fn, devices: int, device_type: str, *args,
           timings: dict | None = None, hosts: Hosts | None = None) -> list:
    """Run ``fn(rank, *args)`` on `devices` ranks, one spawned process each
    (``rank`` a ``Rank``); returns the ranks' results, rank 0 first.  With
    `hosts`, the `devices` ranks are this host's of a group over every
    host, and the results are theirs; one rank then runs in this process.

    The ranks' kernel launches count in this process's counters
    (``kernels.add_launches``); ``timings``, when given, gets ``spawn`` (s
    from the call to the last rank in the group), ``world``, ``backend``,
    ``launches_by_rank``, the slowest rank's ``merge`` and ``exchange``
    seconds and ``merge_bytes`` and ``exchange_bytes``, and the largest
    ``walk_rounds``, ``walk_groups`` and ``walk_collectives`` of a rank (the
    hash-space-sharded walk's).  An exception in any rank re-raises here (the first
    failing rank's own exception, where it pickles); the other ranks are
    stopped.
    """
    from .. import kernels

    if device_type not in BACKENDS:
        raise ValueError(f"no process group for device type {device_type!r}")
    check_devices(devices, device_type)
    store = None
    if hosts and hosts.coordinator:
        init = _coordinated(hosts, devices)
    else:
        # the group's store listens in this process before any rank starts,
        # on a port the system picks as it binds: no other process can take
        # that port between its choice and its use
        import torch.distributed as dist
        store = dist.TCPStore("localhost", 0, devices, is_master=True,
                              wait_for_workers=False, timeout=STORE_TIMEOUT)
        init = ("localhost", store.port, "group")
    t0 = time.time()
    if hosts and devices == 1:
        outs = [_run_rank(0, fn, 1, device_type, init, hosts, args)]
    else:
        outs = _spawn(fn, devices, device_type, init, hosts, args)
        for o in outs:
            kernels.add_launches(o["launches"])
    del store                 # every rank has left the group
    if timings is not None:
        timings["spawn"] = round(max(o["ready"] for o in outs) - t0, 3)
        timings["world"] = devices * (hosts.count if hosts else 1)
        timings["backend"] = BACKENDS[device_type]
        timings["launches_by_rank"] = [o["launches"] for o in outs]
        for name in ("merge", "exchange"):
            timings[name] = round(max(o["stats"][name] for o in outs), 3)
            timings[name + "_bytes"] = max(o["stats"][name + "_bytes"]
                                           for o in outs)
        for name in ("walk_rounds", "walk_groups", "walk_collectives"):
            timings[name] = max(o["stats"][name] for o in outs)
    return [o["result"] for o in outs]


def _spawn(fn, devices, device_type, init, hosts, args) -> list:
    """``_run_rank``'s outcome of `devices` spawned local ranks, rank 0
    first."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    result_dir = tempfile.mkdtemp(prefix="kbbq_ranks_")
    try:
        try:
            mp.start_processes(
                _worker, args=(fn, devices, device_type, init, hosts,
                               result_dir, args),
                nprocs=devices, join=True, start_method="spawn")
        except ProcessException as e:
            errs = []
            for name in os.listdir(result_dir):
                if name.endswith(".err"):
                    with open(os.path.join(result_dir, name), "rb") as f:
                        try:
                            errs.append(pickle.load(f))
                        except Exception:   # torch's report stands instead
                            pass
            if errs:          # the first rank to fail, not the ones it stopped
                raise min(errs, key=lambda te: te[0])[1] from e
            raise
        outs = []
        for r in range(devices):
            with open(os.path.join(result_dir, f"{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    finally:
        shutil.rmtree(result_dir, ignore_errors=True)
    return outs


def slowest(per_rank: list, timings: dict | None) -> None:
    """Into `timings`: per stage the slowest rank's seconds (and the
    largest ``*_peak_bytes``) of the ranks' own tracers' dicts (numbers
    only: their spans and counters stay in each rank's dict)."""
    if timings is None:
        return
    for t in per_rank:
        for name, v in t.items():
            if isinstance(v, (int, float)):
                timings[name] = max(timings.get(name, v), v)


class SharedArrays:
    """Named arrays in ``.npy`` files of one temporary directory: the parent
    writes them (``put``) or makes them empty for the ranks to fill
    (``empty``, ``write_rows``); a rank maps them (``get``) by the handle,
    which pickles as its paths.  ``close`` removes the files; mappings made
    before stay valid."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="kbbq_shared_")

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name + ".npy")

    def empty(self, name: str, shape, dtype) -> None:
        """A zeroed array for the ranks to fill (a sparse file)."""
        mm = np.lib.format.open_memmap(self._path(name), mode="w+",
                                       dtype=dtype, shape=tuple(shape))
        del mm

    def put(self, name: str, arr: np.ndarray) -> None:
        """Write `arr` (plain writes: faster into the page cache than
        stores through a mapping)."""
        np.save(self._path(name), np.ascontiguousarray(arr))

    def get(self, name: str) -> np.ndarray:
        """The array mapped copy-on-write: writes stay in this process."""
        return np.load(self._path(name), mmap_mode="c")

    def write_rows(self, name: str, start: int, rows: np.ndarray) -> None:
        """Write `rows` into the file's rows from `start` on (plain writes
        at the offset; ranks write disjoint rows)."""
        mm = np.load(self._path(name), mmap_mode="r")
        off = mm.offset + start * mm.strides[0]
        del mm
        with open(self._path(name), "r+b") as f:
            f.seek(off)
            f.write(np.ascontiguousarray(rows).data)

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)

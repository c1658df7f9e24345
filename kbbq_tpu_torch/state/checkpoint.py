"""Pass-boundary checkpoints and resume.

Counterpart of ``kbbq_tpu/state/checkpoint.py``.  The natural checkpoints are the pass
boundaries: filter A, filter B and the covariate totals are each one dense
array.  A checkpoint directory holds, with the JAX package's names and
formats, so each package resumes from the other's streamed checkpoints:

  meta.json     the run's fingerprint, ``passes_done``, the covariate shape
                and, for a streamed FASTQ run, ``pass4`` = {chunks, bytes}
  rows_a.npy    filter A after pass 1, packed uint32 [m/32]
  rows_b.npy    filter B after pass 2, packed uint32 [m/32]
                (``rows_a_sharded`` / ``rows_b_sharded`` for the in-memory
                route with the hash-space-sharded layout, the reference's
                names there; the same words, gathered from the shards)
  cov_*.npy     the four int64 covariate tables after pass 3

and, of a run over several hosts (``parallel/multihost.py``), under the
JAX package's names:

  mh_rows_a.npy / mh_rows_b.npy   the replicated layout's filters (host 0)
  mh_sh_rows_a_host{h}.npy / mh_sh_rows_b_host{h}.npy
                host h's part of a hash-space-sharded filter (its ranks'
                shards in order), marked done in ``meta.json`` only once
                every host's part is on disk
  host{h}.json  host h's pass-4 progress: files done, chunks and bytes of
                the file it was writing (each host owns its file, so hosts
                never write ``meta.json`` for their progress)

Filters are saved as their packed words (``state/convert.py``), never as a
byte per slot.  Every file is written to a temporary name and renamed, and a
pass is marked done only after its files are on disk.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib

import numpy as np

from ..constants import DEFAULT_EXT_CAP
from ..oracle.covariate import CovariateTables

_COV_FIELDS = ("cyc_total", "cyc_errors", "din_total", "din_errors")


def effective_ext_cap(config) -> int:
    """The walk's extension cap as it takes effect (None means
    DEFAULT_EXT_CAP), so that a checkpoint written under one default never
    resumes under another."""
    cap = config.ext_cap
    return int(min(DEFAULT_EXT_CAP if cap is None else cap, config.k))


def _config_fields(config) -> dict:
    return {
        "k": config.k,
        "alpha": config.alpha,
        "coverage": config.coverage,
        "genome_length": config.genome_length,
        "num_hashes": config.num_hashes,
        "sampled_bits_per_key": config.sampled_bits_per_key,
        "trusted_bits_per_key": config.trusted_bits_per_key,
        "trust_threshold": config.trust_threshold,
        "ext_cap": effective_ext_cap(config),
    }


def run_fingerprint(config, arrays) -> dict:
    """Config + input identity of an in-memory run: every parameter that
    shapes a pass's output and a CRC32 of all of the read data."""
    h = 0
    for arr in (arrays.codes, arrays.quals, arrays.rgs, arrays.seconds):
        h = zlib.crc32(np.ascontiguousarray(arr), h)
    return {**_config_fields(config),
            "num_reads": int(arrays.num_reads),
            "total_bases": int(arrays.read_lengths().sum()),
            "content_crc32": h}


def stream_fingerprint(config, paths, scan) -> dict:
    """Config + input identity of a streamed run: the parameters, and per
    file its size, the CRC32 of its text (folded during the scan pass,
    ``io/stream.py::scan_fastq_files``) and its read and base counts."""
    return {
        "per_file_sizes": [int(os.path.getsize(p)) for p in paths],
        "per_file_crc32": [int(c) for c in scan.per_file_crc],
        **_config_fields(config),
        "per_file_reads": list(scan.per_file_reads),
        "per_file_bases": list(scan.per_file_bases),
    }


@dataclasses.dataclass
class Checkpoint:
    path: str

    def _meta_path(self):
        return os.path.join(self.path, "meta.json")

    def load_meta(self) -> dict:
        try:
            with open(self._meta_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {"passes_done": []}

    def save_meta(self, meta: dict) -> None:
        os.makedirs(self.path, exist_ok=True)
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path())

    def check_fingerprint(self, fp: dict, record: bool = True) -> None:
        """Refuse to resume a checkpoint taken under different parameters
        or inputs; record the fingerprint on first use (unless `record` is
        false: the other hosts of a multi-host run leave that to host
        0)."""
        meta = self.load_meta()
        stored = meta.get("fingerprint")
        if stored is not None and stored != fp:
            diffs = sorted(key for key in set(stored) | set(fp)
                           if stored.get(key) != fp.get(key))
            raise ValueError(
                f"checkpoint at {self.path} was created with different "
                f"parameters or input data (mismatched: {', '.join(diffs)}); "
                "delete the checkpoint directory or point --checkpoint-dir "
                "elsewhere")
        if stored is None and record:
            meta["fingerprint"] = fp
            self.save_meta(meta)

    # ------------------------------------------------------- several hosts
    def _host_path(self, pid: int) -> str:
        return os.path.join(self.path, f"host{pid}.json")

    def load_host_meta(self, pid: int) -> dict:
        """Host `pid`'s pass-4 progress ({} before any)."""
        try:
            with open(self._host_path(pid)) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def save_host_meta(self, pid: int, d: dict) -> None:
        os.makedirs(self.path, exist_ok=True)
        tmp = self._host_path(pid) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, self._host_path(pid))

    def save_host_array(self, pid: int, name: str, arr) -> None:
        """Host `pid`'s part of a pass artifact, NOT marked done: the caller
        marks the pass (``mark_pass``) once every host's part is on
        disk."""
        os.makedirs(self.path, exist_ok=True)
        path = os.path.join(self.path, f"{name}_host{pid}.npy")
        np.save(path + ".tmp.npy", np.asarray(arr))
        os.replace(path + ".tmp.npy", path)

    def load_host_array(self, pid: int, name: str) -> np.ndarray | None:
        """Host `pid`'s part if the pass is marked done, else None; mapped
        read-only."""
        if name not in self.load_meta()["passes_done"]:
            return None
        path = os.path.join(self.path, f"{name}_host{pid}.npy")
        if not os.path.exists(path):
            raise ValueError(
                f"checkpoint marks {name} complete but host {pid}'s part is "
                f"missing: was the run restarted with a different process "
                f"count?")
        return np.load(path, mmap_mode="r")

    def mark_pass(self, name: str) -> None:
        """Mark a pass done (after all of its files are on disk)."""
        self._mark(self.load_meta(), name)

    def _mark(self, meta: dict, name: str) -> None:
        if name not in meta["passes_done"]:
            meta["passes_done"].append(name)
        self.save_meta(meta)

    def save_array(self, name: str, arr: np.ndarray) -> None:
        """Save a pass artifact (``rows_a``, ``rows_b``) and mark it done."""
        os.makedirs(self.path, exist_ok=True)
        path = os.path.join(self.path, f"{name}.npy")
        np.save(path + ".tmp.npy", np.asarray(arr))
        os.replace(path + ".tmp.npy", path)
        self._mark(self.load_meta(), name)

    def load_array(self, name: str) -> np.ndarray | None:
        """The artifact if its pass is marked done, else None; mapped
        read-only (a rank of the sharded layout reads only its slice)."""
        if name not in self.load_meta()["passes_done"]:
            return None
        return np.load(os.path.join(self.path, f"{name}.npy"),
                       mmap_mode="r")

    def save_covariates(self, tables: CovariateTables) -> None:
        os.makedirs(self.path, exist_ok=True)
        for f in _COV_FIELDS:
            path = os.path.join(self.path, f"cov_{f}.npy")
            np.save(path + ".tmp.npy", getattr(tables, f))
            os.replace(path + ".tmp.npy", path)
        meta = self.load_meta()
        meta["cov"] = {"num_rg": tables.num_rg, "max_len": tables.max_len}
        self._mark(meta, "covariates")

    def load_covariates(self) -> CovariateTables | None:
        meta = self.load_meta()
        if "covariates" not in meta["passes_done"]:
            return None
        arrs = {f: np.load(os.path.join(self.path, f"cov_{f}.npy"))
                for f in _COV_FIELDS}
        return CovariateTables(meta["cov"]["num_rg"],
                               meta["cov"]["max_len"], **arrs)

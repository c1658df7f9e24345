"""Pass-boundary checkpoints and resume.

Counterpart of ``kbbq_tpu/state/checkpoint.py`` (single process: without
the multi-host sidecar files).  The natural checkpoints are the pass
boundaries: filter A, filter B and the covariate totals are each one dense
array.  A checkpoint directory holds, with the JAX package's names and
formats, so each package resumes from the other's streamed checkpoints:

  meta.json     the run's fingerprint, ``passes_done``, the covariate shape
                and, for a streamed FASTQ run, ``pass4`` = {chunks, bytes}
  rows_a.npy    filter A after pass 1, packed uint32 [m/32]
  rows_b.npy    filter B after pass 2, packed uint32 [m/32]
  cov_*.npy     the four int64 covariate tables after pass 3

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
            "total_bases": int(arrays.mask.sum()),
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

    def check_fingerprint(self, fp: dict) -> None:
        """Refuse to resume a checkpoint taken under different parameters
        or inputs; record the fingerprint on first use."""
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
        if stored is None:
            meta["fingerprint"] = fp
            self.save_meta(meta)

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
        """The artifact if its pass is marked done, else None."""
        if name not in self.load_meta()["passes_done"]:
            return None
        return np.load(os.path.join(self.path, f"{name}.npy"))

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

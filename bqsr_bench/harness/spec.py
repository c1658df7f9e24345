"""Everything the harness runs is found by name: a cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``) and
its traffic (``workloads/<name>.json``), a configuration names its input
format (``formats/<format>.py``: the input file's writer and the output's
judge), and every metric has its reader in ``metrics/<name>.py``.  A name
with no file raises; nothing falls back."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(ValueError):
    """A cell, configuration, traffic or metric that is not there."""


def _load_json(kind: str, name: str) -> dict:
    path = os.path.join(BENCH_DIR, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise SpecError(f"no {kind} file for {name!r}: {path}")
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise SpecError(f"no benchmark manifest at {path}")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _load_json("configs", name)


def traffic(name: str) -> dict:
    return _load_json("workloads", name)


def cell(name: str, man: dict | None = None) -> dict:
    """The cell `name` with its configuration and traffic loaded, and the
    metrics it reports: {"name", "chips", "config", "traffic",
    "end_to_end", "per_layer"} (each metric list the manifest's entries
    whose ``workloads`` include the cell or which have none)."""
    man = man or manifest()
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise SpecError(f"no cell {name!r} in the manifest")
    w = found[0]
    cfg = config(w["config"])
    tr = traffic(w["traffic"])
    input_format(cfg.get("format", ""))
    if cfg.get("format") != tr.get("input"):
        raise SpecError(f"traffic {w['traffic']!r} takes {tr.get('input')!r}"
                        f" input, configuration {w['config']!r} is "
                        f"{cfg.get('format')!r}")

    def mine(metrics):
        return [m for m in metrics
                if name in m.get("workloads", [name])]
    return {"name": name, "chips": int(w["chips"]), "config": cfg,
            "traffic": tr, "end_to_end": mine(man["end_to_end"]),
            "per_layer": mine(man["per_layer"])}


def _load_py(kind: str, name: str, needs: tuple):
    """The module ``<kind>/<name>.py``, loaded from its file (a name may hold
    dots and dashes); it must define each of `needs`."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise SpecError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"bqsr_bench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [n for n in needs if not callable(getattr(mod, n, None))]
    if missing:
        raise SpecError(f"{path} defines no {', '.join(missing)}")
    return mod


def input_format(name: str):
    """The module ``formats/<name>.py``: ``write(tmpdir, reads, cfg)`` and
    ``expected(reads, layout, new_quals, cfg)``."""
    return _load_py("formats", name, ("write", "expected"))


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return _load_py("metrics", metric, ("read",)).read

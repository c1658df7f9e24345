"""The check that nothing the run loaded is JAX or the JAX package.

Modules are compared by their top-level name (the part before the first
dot), whole: ``kbbq_tpu_torch`` is the program and is not ``kbbq_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kbbq_tpu"})


class ForbiddenModules(RuntimeError):
    pass


def forbidden(names=None) -> list:
    """The forbidden top-level names among `names` (default: every module
    loaded in this process), sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)

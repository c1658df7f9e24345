"""The port's one tracer: the stages and spans of a recalibration job.

An entry point's ``timings`` argument switches it on: ``tracer(timings,
dev)`` gives ``OFF`` for None, else the job's tracer, which the nested
calls of the same job (given the same ``timings`` dict) find again, so one
tracer serves one job.  Use it as a context manager; the outermost ``with``
closes it.

Off, every method returns at once: ``span`` returns ``OFF`` itself, a
context that does nothing.  No clock is read, no profiler range or CUDA
event is made, nothing synchronises and nothing is allocated.

On:

- ``stage(name)`` closes the open top-level stage and opens `name`
  (``stage(None)`` opens none).  Closing a stage writes ``timings[name]``
  (seconds, to the millisecond); on a card that this process has
  already used, it first synchronises the card and also writes
  ``timings[name + "_peak_bytes"]`` (the peak of allocated device memory
  while it ran).  A process that has not touched the card (the parent
  of several ranks) is not made to.  Stages are opened by name, not closed by it, because
  a profiler range needs its name when it opens.
- ``span(name, device=False, parent=None)`` opens a nested span.  Stages
  and spans are ``torch.profiler.record_function("kbbq.<name>")`` ranges,
  so any profiler trace shows them on the clock of the card's kernels
  and copies.  A span with ``device=True`` also records a CUDA event pair
  on the current stream, resolved when the tracer closes (after the
  job's last stage has synchronised): no synchronise is added for it.  A
  span on a worker thread takes as its parent the span (``current()``)
  that was open where its work was handed over.
- ``count(name, n)`` adds `n` to ``timings["counters"][name]``;
  ``count_open(name, n)`` does it on the tracer open in this context.
- On closing, ``timings["spans"]`` gets every kept stage and span once:
  ``{"id", "name", "start", "end", "thread", "parent"}`` (seconds since
  the tracer opened; ``thread`` the ``threading.get_ident()`` of the
  thread it ran on; ``parent`` the id of the enclosing span, None for a
  stage), and ``"device_s"`` for a device span on a card.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time

import torch

PREFIX = "kbbq."

# the tracer's clock (the tests replace it to show that OFF never reads it)
_clock = time.perf_counter

# the tracer of the job running in this context, found by nested calls
_OPEN: contextvars.ContextVar = contextvars.ContextVar("kbbq_tracer",
                                                       default=None)


class _Off:
    """The tracer of a job run without ``timings``."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def stage(self, name) -> None:
        pass

    def span(self, name, device=False, parent=None):
        return self

    def count(self, name, n) -> None:
        pass

    def current(self):
        return None


OFF = _Off()


def tracer(timings: dict | None, dev):
    """The tracer of the job that fills `timings`: OFF for None, the one
    already open on this dict (a nested call of the same job), else a new
    one on device `dev`."""
    if timings is None:
        return OFF
    cur = _OPEN.get()
    if cur is not None and cur.timings is timings:
        return cur
    return Tracer(timings, dev)


def count_open(name: str, n) -> None:
    """``count(name, n)`` on the tracer of the job running in this context,
    if one is open: for code that is handed no tracer."""
    cur = _OPEN.get()
    if cur is not None:
        cur.count(name, n)


class Tracer:
    """The tracer of one job (see the module's docstring)."""

    def __init__(self, timings: dict, dev):
        self.timings = timings
        self.dev = torch.device(dev)
        self.cuda = self.dev.type == "cuda"
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._kept: list = []
        self._events: list = []
        self._counters: dict = {}
        self._stage = None      # (record, profiler range) of the open stage
        self._depth = 0
        self._token = None
        self.t0 = _clock()
        if self._on_card():
            torch.cuda.reset_peak_memory_stats(self.dev)

    def __enter__(self):
        self._depth += 1
        if self._depth == 1:
            self._token = _OPEN.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._depth -= 1
        if self._depth == 0:
            _OPEN.reset(self._token)
            if exc_type is None:
                self.close()
            elif self._stage is not None:
                self._stage[1].__exit__(None, None, None)
                self._stage = None
        return False

    def _on_card(self) -> bool:
        return self.cuda and torch.cuda.is_initialized()

    def _now(self) -> float:
        return _clock() - self.t0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, rec: dict) -> None:
        with self._lock:
            self._kept.append(rec)

    def stage(self, name: str | None) -> None:
        if self._stage is not None:
            rec, rng = self._stage
            self._stage = None
            if self._on_card():
                torch.cuda.synchronize(self.dev)
                self.timings[rec["name"] + "_peak_bytes"] = \
                    torch.cuda.max_memory_allocated(self.dev)
                torch.cuda.reset_peak_memory_stats(self.dev)
            rng.__exit__(None, None, None)
            rec["end"] = self._now()
            self.timings[rec["name"]] = round(rec["end"] - rec["start"], 3)
            self._keep(rec)
        if name is not None:
            rec = {"id": next(self._ids), "name": name, "start": self._now(),
                   "end": None, "thread": threading.get_ident(),
                   "parent": None}
            rng = torch.profiler.record_function(PREFIX + name)
            rng.__enter__()
            self._stage = (rec, rng)

    def current(self):
        """The id of the innermost span open on this thread, else of the
        open stage (None without one): a worker's span takes it as its
        parent."""
        stack = self._stack()
        if stack:
            return stack[-1]
        return self._stage[0]["id"] if self._stage is not None else None

    def span(self, name: str, device: bool = False, parent=None):
        return _Span(self, name, device, parent)

    def count(self, name: str, n) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def close(self) -> None:
        """Close the open stage; spans and counters into ``timings``."""
        self.stage(None)
        for rec, a, b in self._events:
            rec["device_s"] = a.elapsed_time(b) * 1e-3
        self.timings["counters"] = dict(self._counters)
        self.timings["spans"] = sorted(self._kept, key=lambda r: r["id"])


class _Span:
    """One span of a Tracer, as a context manager."""

    __slots__ = ("tr", "name", "device", "parent", "rec", "rng", "events")

    def __init__(self, tr: Tracer, name: str, device: bool, parent):
        self.tr, self.name, self.device = tr, name, device
        self.parent = parent

    def __enter__(self):
        tr = self.tr
        stack = tr._stack()
        parent = stack[-1] if stack else (
            self.parent if self.parent is not None else tr.current())
        self.rec = {"id": next(tr._ids), "name": self.name,
                    "start": tr._now(), "end": None,
                    "thread": threading.get_ident(), "parent": parent}
        stack.append(self.rec["id"])
        self.rng = torch.profiler.record_function(PREFIX + self.name)
        self.rng.__enter__()
        self.events = None
        if self.device and tr.cuda:
            stream = torch.cuda.current_stream(tr.dev)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.tr
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(tr.dev))
        self.rng.__exit__(exc_type, exc, tb)
        tr._stack().pop()
        self.rec["end"] = tr._now()
        if self.events is not None:
            with tr._lock:
                tr._events.append((self.rec, *self.events))
        tr._keep(self.rec)
        return False

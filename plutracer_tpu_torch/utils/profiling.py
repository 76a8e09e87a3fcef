"""Profiling and metrics.

The port of plutracer_tpu/utils/profiling.py:

- ``PhaseTimer``: wall-clock phase timing (the reference's init / render /
  postprocess prints, src/main.cpp:146-204) with a structured report.
- ``RenderStats``: samples/s and issued rays/s derived from the image
  shape and the integrator's worst-case query count.
- ``profile_trace``: a torch.profiler trace (the host, and CUDA once a
  card is in use) of the enclosed block, written into a directory as a
  Chrome trace (the CLI's /profile).

And the port's own record of its layers, one registry a process, off by
default:

- ``span(name)``: a ``with`` block marking a layer boundary inside the
  program (``plu.render``, ``plu.render.keys``, ``plu.train.forward``,
  ...). Off, it reads two flags and returns a shared no-op: no clock read,
  no profiler call. On, it enters ``torch.profiler.record_function(name)``
  (so the span is in any kineto / Chrome trace, on the clock of the
  device records) and appends an ``Entry`` (name, request, parent, start,
  end) stamped with ``time.time_ns()``, the wall clock kineto stamps its
  host events with (within a millisecond of the annotation's own event). A span opened with ``request=True`` and no request
  open on its thread (one ``render`` call, one train step) starts a
  request, and every span inside it carries the request's id. The parent
  stack is a thread's own: autograd's engine runs backward functions on
  threads of its own, whose spans start there without a parent.
- ``count(name, k)``: adds k to a counter (``launches.k1``, ``k1_bvh``,
  ``k2``, ``k2_debug``, ``k3``, ``k3_debug``, ``k4``, ``r1``, ``r2``, ``g1``: the
  kernel records each C entry point puts on the card, one a call;
  ``device_entries``: the blocks of ``ops/cuda/build.on_device``);
  ``counter(name)`` reads one.
- Recording is on while a torch profiler session is active
  (``profiler_active``: a traced window, the CLI's /profile)
  and inside a ``recording()`` block. ``recorded()`` gives the record,
  ``reset()`` clears it. Nothing records across a generator's ``yield``:
  spans are ``with`` blocks that close before it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class PhaseTimer:
    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "\n".join(f"{k} took: {int(v * 1000)}ms" for k, v in self.phases.items())

    def as_json(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.phases.items()})


@dataclasses.dataclass
class RenderStats:
    """Throughput accounting for one render.

    A sample is a full camera path. Each of its max_bounces shading
    vertices issues at most 3 closest-hit queries (the extension ray and
    the two NEE visibility rays, renderer.cpp:16,41,86), so a sample
    issues at most 3 * max_bounces.
    """

    width: int
    height: int
    spp: int
    seconds: float
    max_bounces: int = 8

    @property
    def samples(self) -> int:
        return self.width * self.height * self.spp

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.seconds, 1e-12)

    @property
    def rays_per_sec_upper(self) -> float:
        return self.samples_per_sec * 3 * self.max_bounces

    def report(self) -> str:
        return (
            f"{self.samples} samples in {self.seconds:.2f}s = "
            f"{self.samples_per_sec / 1e6:.2f} Msamples/s "
            f"(<= {self.rays_per_sec_upper / 1e6:.1f} Mrays/s issued)"
        )


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler trace of the enclosed block, written into the
    directory `log_dir` (made if missing), as the JAX package's
    profile_trace(log_dir) writes its device trace there.
    torch.profiler.tensorboard_trace_handler names the file
    ``<host>_<pid>.<ns>.pt.trace.json``, so traces of one directory
    accumulate (a Chrome trace, which TensorBoard's profiler plugin also
    reads). The host is always recorded; CUDA too whenever a card is
    initialised in this process."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def profiler_active() -> bool:
    """Whether a torch profiler session (torch.profiler.profile or
    torch.autograd.profiler.profile) is recording in this process: the
    flag the profiler sets while it runs, read without a call into the C
    library (some tens of ns)."""
    return _autograd_profiler._is_profiler_enabled


class Entry(NamedTuple):
    """One span: its request (None outside any), its parent's index in
    the record's entries (None at the top of its thread), and its start
    and end (time.time_ns(); end 0 while the span is open)."""

    name: str
    request: Optional[int]
    parent: Optional[int]
    start_ns: int
    end_ns: int


class _Record:
    """The process's record: entries and counters behind one lock (spans
    and counts come from the autograd engine's threads too)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.entries: List[Entry] = []
        self.counters: Dict[str, int] = {}
        self.explicit = 0  # recording() blocks open
        self.generation = 0  # reset()s so far: a span open across one is dropped
        self.requests = 0
        self.local = threading.local()  # .stack: the thread's open spans

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORD = _Record()


def _on() -> bool:
    return _RECORD.explicit > 0 or profiler_active()


class _Span:
    __slots__ = ("name", "opens", "request", "index", "generation", "annotation")

    def __init__(self, name: str, opens: bool) -> None:
        self.name, self.opens = name, opens

    def __enter__(self):
        rec = _RECORD
        stack = rec.stack()
        top = stack[-1] if stack else None
        # stamped before the annotation opens and before it closes: its
        # first call in a process spends most of a millisecond after
        # kineto's stamp
        start = time.time_ns()
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        with rec.lock:
            parent = top.index if top is not None and top.generation == rec.generation else None
            self.request = top.request if top is not None else None
            if self.request is None and self.opens:
                rec.requests += 1
                self.request = rec.requests
            self.index, self.generation = len(rec.entries), rec.generation
            rec.entries.append(Entry(self.name, self.request, parent, start, 0))
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = _RECORD
        rec.stack().pop()
        with rec.lock:
            if self.generation == rec.generation:
                rec.entries[self.index] = rec.entries[self.index]._replace(end_ns=end)
        self.annotation.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, request: bool = False):
    """``with span(name):`` records the block as a span while recording is
    on (see the module's docstring); request=True starts a request where
    none is open on this thread."""
    if not _on():
        return _OFF
    return _Span(name, request)


def count(name: str, k: int = 1) -> None:
    """Add k to the counter `name` while recording is on."""
    if _on():
        with _RECORD.lock:
            _RECORD.counters[name] = _RECORD.counters.get(name, 0) + k


def counter(name: str) -> int:
    """The counter `name` as recorded so far (0 if never counted)."""
    with _RECORD.lock:
        return _RECORD.counters.get(name, 0)


@contextlib.contextmanager
def recording():
    """Record inside the block, with or without a profiler."""
    with _RECORD.lock:
        _RECORD.explicit += 1
    try:
        yield
    finally:
        with _RECORD.lock:
            _RECORD.explicit -= 1


def recorded() -> dict:
    """The record: ``spans`` (name -> count, inclusive_ns and self_ns of
    its closed spans; self time is inclusive time less the time of the
    span's children), ``counters`` (name -> count) and ``entries`` (every
    Entry, in the order the spans opened)."""
    with _RECORD.lock:
        entries = list(_RECORD.entries)
        counters = dict(_RECORD.counters)
    children = [0] * len(entries)
    for e in entries:
        if e.end_ns and e.parent is not None:
            children[e.parent] += e.end_ns - e.start_ns
    spans: Dict[str, Dict[str, int]] = {}
    for e, inner in zip(entries, children):
        if e.end_ns:
            s = spans.setdefault(e.name, {"count": 0, "inclusive_ns": 0, "self_ns": 0})
            s["count"] += 1
            s["inclusive_ns"] += e.end_ns - e.start_ns
            s["self_ns"] += e.end_ns - e.start_ns - inner
    return {"spans": spans, "counters": counters, "entries": entries}


def reset() -> None:
    """Clear the record (spans open now are left out of it when they
    close)."""
    with _RECORD.lock:
        _RECORD.entries = []
        _RECORD.counters = {}
        _RECORD.generation += 1

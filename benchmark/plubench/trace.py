"""The device trace of a window and its reduction.

``Tracer`` runs the window under torch.profiler (CPU and CUDA activity)
and keeps the raw events; ``reduce_events`` turns them into what the
per-layer readers and the result's ``device`` and ``breakdown`` need. The
reduction is plain arithmetic on (kind, name, start, end) records, so it
is tested on a canned trace without a card.

- device intervals: the kernel, memcpy and memset records of the card;
- the traced window: the harness's ``bench.window`` span;
- busy time: the union of the device intervals inside the window;
- launches: the kernel records inside the window, of any name;
- idle gaps: the window less the union, each labelled by what the host
  was doing at the gap's middle (the harness span, and the outermost
  operator active then).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
SPAN_PREFIX = "bench."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class Event:
    kind: str  # "kernel", "gpu_memcpy", "gpu_memset", "cpu_op", "user_annotation", ...
    name: str
    start: int  # ns
    end: int  # ns
    on_device: bool


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    launches: int  # kernel records in the window
    device_ops: List[Tuple[str, float]]  # the device operations that took most time
    idle_gaps: List[Tuple[str, float]]  # idle seconds by what the host was doing
    device_s_by_name: Dict[str, float]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def union(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals clipped to [lo, hi), sorted and
    disjoint."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gaps(covered: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """[lo, hi) less the disjoint sorted intervals `covered`."""
    out, at = [], lo
    for s, e in covered:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def _outermost(events: List[Event]) -> List[Event]:
    """The events not inside another of the list, sorted by start (on one
    thread these are disjoint)."""
    out: List[Event] = []
    for e in sorted(events, key=lambda e: (e.start, -e.end)):
        if not out or e.start >= out[-1].end:
            out.append(e)
    return out


def _at(events: List[Event], starts: List[int], t: int) -> Optional[Event]:
    """The event of a disjoint sorted list that holds t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    return events[i] if i >= 0 and events[i].end > t else None


def _labeller(host: List[Event]):
    """t -> what the host was doing at t: the harness span (spans do not
    nest inside the window) and the outermost operator active at t."""
    spans = _outermost([e for e in host if e.kind == "user_annotation"
                        and e.name.startswith(SPAN_PREFIX) and e.name != WINDOW_SPAN])
    ops = _outermost([e for e in host if e.kind == "cpu_op"])
    span_starts, op_starts = [e.start for e in spans], [e.start for e in ops]

    def label(t: int) -> str:
        span, op = _at(spans, span_starts, t), _at(ops, op_starts, t)
        return "/".join([span.name[len(SPAN_PREFIX):] if span else "harness",
                         op.name if op else "python"])
    return label


def reduce_events(events: List[Event]) -> Optional[Reduced]:
    """The window's reduction, or None where the trace holds no window span
    or no device record in it."""
    windows = [e for e in events if e.name == WINDOW_SPAN and not e.on_device]
    if not windows:
        return None
    lo, hi = windows[0].start, windows[0].end
    dev = [e for e in events if e.on_device and e.kind in DEVICE_KINDS
           and e.end > lo and e.start < hi]
    if not dev:
        return None
    covered = union([(e.start, e.end) for e in dev], lo, hi)
    busy = sum(e - s for s, e in covered)
    by_name: Dict[str, float] = {}
    for e in dev:
        s, t = max(e.start, lo), min(e.end, hi)
        by_name[e.name] = by_name.get(e.name, 0.0) + max(0, t - s) * 1e-9
    label_at = _labeller([e for e in events if not e.on_device and e.end > lo and e.start < hi])
    idle: Dict[str, float] = {}
    for s, t in gaps(covered, lo, hi):
        label = label_at((s + t) // 2)
        idle[label] = idle.get(label, 0.0) + (t - s) * 1e-9
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
    return Reduced(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                   launches=sum(1 for e in dev if e.kind == "kernel" and lo <= e.start < hi),
                   device_ops=top(by_name), idle_gaps=top(idle), device_s_by_name=by_name)


def _kind(e, on_device: bool) -> str:
    """The record's activity: the profiler's own where it gives one, else
    from the record's device, annotation flag and name."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    annotation = bool(getattr(e, "is_user_annotation", lambda: False)())
    if not on_device:
        return "user_annotation" if annotation else "cpu_op"
    if annotation:
        return "gpu_user_annotation"
    name = e.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else (
        "gpu_memset" if name.startswith("Memset") else "kernel")


def kineto_events(prof) -> List[Event]:
    """The profiler's raw records as Events (device records are those on a
    CUDA device)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = "CUDA" in str(e.device_type())
        start = int(e.start_ns())
        out.append(Event(kind=_kind(e, on_device), name=e.name(), start=start,
                         end=start + int(e.duration_ns()), on_device=on_device))
    return out


class Tracer:
    """``with tracer.window():`` runs the block as the traced window (under
    torch.profiler with CPU and CUDA activity when on); ``tracer.span(name)``
    marks a harness span inside it. Off, both cost nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.events: List[Event] = []

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            with record_function(WINDOW_SPAN):
                yield
            if cuda:
                torch.cuda.synchronize()
        self.events = kineto_events(prof)

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)

    def reduced(self) -> Optional[Reduced]:
        return reduce_events(self.events) if self.on else None

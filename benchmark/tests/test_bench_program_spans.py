"""The readers of the program's own spans and counters (utils/profiling),
on a record built through the registry's API with a scripted clock and a
canned context, and the canned trace with the program's annotations in
it."""

import pytest

from plubench import spec
from plubench.main import Context
from plubench.trace import reduce_events
from plutracer_tpu_torch.utils import profiling
from test_bench_trace import CANNED, MS, ev

RENDER = ("pass_loop_host_ms_per_image", "key_derivation_ms_per_image",
          "eager_launches_per_image")
TRAIN = ("train_forward_ms_per_step", "train_backward_ms_per_step")


class Clock:
    """time.time_ns a millisecond further on each call."""

    def __init__(self):
        self.now = 0

    def time_ns(self):
        self.now += MS
        return self.now


class Loop:
    def __init__(self, kind):
        self.kind = kind
        self.times = [0.05, 0.05]  # two items completed
        self.spans = {}
        self.least_s = None


@pytest.fixture
def record(monkeypatch):
    """Two images and two steps through the registry: each image a
    plu.render of 5 ms holding a plu.render.keys of 1 ms, each step a
    plu.train.step holding a 1 ms forward and a 3 ms backward; the
    program's kernels counted 2 launches (of CANNED's 3 kernel records)."""
    monkeypatch.setattr(profiling, "time", Clock())
    profiling.reset()
    with profiling.recording():
        for _ in range(2):
            with profiling.span("plu.render", request=True):  # 1 .. 6
                with profiling.span("plu.render.keys"):  # 2 .. 3
                    pass
                with profiling.span("plu.render.radiance"):  # 4 .. 5
                    profiling.count("launches.k2")
        for _ in range(2):
            with profiling.span("plu.train.step", request=True):
                with profiling.span("plu.train.forward"):
                    pass
                with profiling.span("plu.train.backward"):
                    with profiling.span("plu.train.inner"):
                        pass
    yield profiling.recorded()
    profiling.reset()


def read(name, kind, trace=True):
    return spec.metric_reader(name)(Context(Loop(kind), reduce_events(CANNED) if trace else None))


def test_readers_on_the_programs_record(record):
    assert record["spans"]["plu.render"] == {"count": 2, "inclusive_ns": 10 * MS,
                                            "self_ns": 6 * MS}
    assert read("pass_loop_host_ms_per_image", "render") == 5.0
    assert read("key_derivation_ms_per_image", "render") == 1.0
    assert read("eager_launches_per_image", "render") == 0.5  # (3 - 2) / 2
    assert read("train_forward_ms_per_step", "train") == 1.0
    assert read("train_backward_ms_per_step", "train") == 3.0


@pytest.mark.parametrize("name", RENDER + TRAIN)
def test_readers_find_nothing_untraced_or_in_the_other_kind(record, name):
    kind, other = ("render", "train") if name in RENDER else ("train", "render")
    assert read(name, kind) is not None
    assert read(name, kind, trace=False) is None
    assert read(name, other) is None


@pytest.mark.parametrize("name", RENDER + TRAIN)
def test_readers_find_nothing_without_a_record(monkeypatch, name):
    """An empty record (no profiler ran) and a program without the
    registry (an earlier tree): nothing to read, nothing raised."""
    kind = "render" if name in RENDER else "train"
    profiling.reset()
    assert read(name, kind) is None
    monkeypatch.delattr(profiling, "recorded")
    assert read(name, kind) is None


def test_program_annotations_leave_the_reduction_as_it_was():
    """The program's plu.* spans are user annotations without the bench.
    prefix: the window, busy time, launches, device operations and idle
    labels of the canned trace stay as they were."""
    spans = [ev("user_annotation", "plu.render", 1, 79),
             ev("user_annotation", "plu.render.keys", 2, 4),
             ev("user_annotation", "plu.render.radiance", 4, 45),
             ev("user_annotation", "plu.tables.pack", 41, 49),
             ev("user_annotation", "plu.tonemap", 81, 84),
             ev("gpu_user_annotation", "plu.render.radiance", 5, 40, dev=True)]
    assert reduce_events(CANNED + spans) == reduce_events(CANNED)
    assert reduce_events(spans + CANNED) == reduce_events(CANNED)


def test_kineto_classifies_program_spans_as_annotations():
    """A program span under torch.profiler reaches the harness's events as
    a user_annotation, not an operator."""
    from torch.profiler import ProfilerActivity, profile

    from plubench.trace import kineto_events

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("plu.render"):
            pass
    profiling.reset()
    kinds = {e.kind for e in kineto_events(prof) if e.name == "plu.render"}
    assert kinds == {"user_annotation"}

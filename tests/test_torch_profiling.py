"""The port's spans and counters (utils/profiling), on the CPU.

Off (no profiler, no recording() block) a span checks a flag and returns
a shared no-op: a render reads no clock, makes no record_function call and
records nothing. On, each span is a record_function annotation too, so it
sits in the profiler's trace: its start and end (time.time_ns(), taken
inside the annotation) lie within 1 ms of the kineto event of the same
span. Spans nest by thread, a request is one render or one train step,
and a generator's spans close before its yield.
"""

import sys
import threading
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.parallel import sharded
from plutracer_tpu_torch.render import renderer
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.utils import profiling
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

W, H, N = 8, 6, 2  # 4 strata, one launch each on the CPU
RENDER_SPANS = ("plu.render", "plu.render.keys", "plu.render.draws", "plu.render.rays",
                "plu.render.radiance", "plu.tables.pack", "plu.render.accumulate",
                "plu.render.finalize")
TRAIN_SPANS = ("plu.train.step", "plu.train.forward", "plu.train.backward", "plu.train.filter",
               "plu.train.reduce", "plu.train.optimizer")
SLACK_NS = 1_000_000  # a span against its kineto event


@pytest.fixture(scope="module")
def scene():
    return compile_scene(load_scene_file("scenes/demo-box.urn", ["/res", f"{W}x{H}"]),
                         device="cpu")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def image(scene, seed=0):
    return renderer.render(scene, W, H, N, rng.PRNGKey(seed))


def closed(rec):
    return [e for e in rec["entries"] if e.end_ns]


@pytest.mark.parametrize("session", [
    lambda: profile(activities=[ProfilerActivity.CPU]),
    lambda: torch.autograd.profiler.profile(),
], ids=["torch.profiler.profile", "torch.autograd.profiler.profile"])
def test_profiler_active_follows_the_profiler(session):
    """The one helper that reads the profiler's state: on exactly while a
    torch profiler session runs, and recording() does not turn it on (a
    torch upgrade that moves the flag fails here)."""
    assert not profiling.profiler_active()
    with profiling.recording():
        assert not profiling.profiler_active()
    with session():
        assert profiling.profiler_active()
        profiling.count("launches.k1")
    assert not profiling.profiler_active()
    profiling.count("launches.k1")
    assert profiling.counter("launches.k1") == 1


def test_off_reads_no_clock_and_calls_no_profiler(scene, monkeypatch):
    """Recording off, a render takes neither the clock nor record_function
    (both made to fail) and records nothing; the same render with
    recording on reaches both."""
    def boom(*a, **k):
        raise AssertionError("called with recording off")

    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        time_ns=boom, perf_counter=time.perf_counter))
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    image(scene)
    assert profiling.recorded() == {"spans": {}, "counters": {}, "entries": []}
    with profiling.recording(), pytest.raises(AssertionError, match="recording off"):
        image(scene)


def test_render_under_the_profiler(scene):
    """Under torch.profiler.profile, two renders record every pass-loop
    span under its image's plu.render, one request an image; self time is
    at most inclusive time; children lie inside their parents; and each
    span agrees with its kineto user_annotation within 1 ms (record_function
    warmed up first: its first call in a process sets the operator up)."""
    with torch.profiler.record_function("warm-up"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        image(scene, 0)
        image(scene, 1)
    rec = profiling.recorded()
    entries = closed(rec)
    assert len(entries) == len(rec["entries"])
    assert set(rec["spans"]) == set(RENDER_SPANS)
    launches = N * N  # one stratum a launch on the CPU
    per_image = {"plu.render": 1, "plu.render.keys": launches,
                 "plu.render.draws": launches, "plu.render.rays": launches,
                 "plu.render.radiance": launches, "plu.render.accumulate": launches,
                 "plu.render.finalize": 1}
    for name, k in per_image.items():
        assert rec["spans"][name]["count"] == 2 * k, name
    assert rec["spans"]["plu.tables.pack"]["count"] >= 2 * launches
    roots = [e for e in entries if e.name == "plu.render"]
    assert [e.parent for e in roots] == [None, None]
    assert roots[0].request != roots[1].request and None not in (roots[0].request,
                                                                  roots[1].request)
    for i, e in enumerate(entries):
        if e.name == "plu.render":
            continue
        p = entries[e.parent]
        assert p.start_ns <= e.start_ns <= e.end_ns <= p.end_ns, (e, p)
        assert e.request == p.request
        if e.name == "plu.tables.pack":
            while p.name != "plu.render.radiance":
                p = entries[p.parent]
        else:
            assert p.name == "plu.render", e
    for s in rec["spans"].values():
        assert 0 <= s["self_ns"] <= s["inclusive_ns"]
    kineto = {}
    for k in prof.profiler.kineto_results.events():
        if k.name().startswith("plu."):
            kineto.setdefault(k.name(), []).append((k.start_ns(), k.start_ns() + k.duration_ns()))
    assert set(kineto) == set(RENDER_SPANS)
    for name, spans in kineto.items():
        mine = sorted((e.start_ns, e.end_ns) for e in entries if e.name == name)
        assert len(mine) == len(spans), name
        for (s, t), (ks, kt) in zip(mine, sorted(spans)):
            assert abs(s - ks) < SLACK_NS and abs(t - kt) < SLACK_NS, (name, s - ks, t - kt)


def test_recording_without_a_profiler_and_reset(scene):
    """recording() records without a profiler; reset() empties the record,
    and a span open across a reset is left out."""
    with profiling.recording():
        image(scene)
        profiling.count("launches.k2", 3)
        with profiling.span("plu.render"):
            profiling.reset()
    assert profiling.recorded() == {"spans": {}, "counters": {}, "entries": []}
    with profiling.recording():
        image(scene)
        profiling.count("launches.k2", 3)
    rec = profiling.recorded()
    assert rec["spans"]["plu.render"]["count"] == 1 and rec["counters"] == {"launches.k2": 3}
    assert profiling.counter("launches.k2") == 3 and profiling.counter("launches.k1") == 0
    profiling.count("launches.k2")  # recording off: not counted
    assert profiling.counter("launches.k2") == 3
    profiling.reset()
    assert profiling.recorded() == {"spans": {}, "counters": {}, "entries": []}


def test_train_step_records_its_spans(scene):
    """A CPU train step records plu.train.step, a request, with its five
    stages and its key derivation (plu.render.keys) inside it, and the
    render spans of its forward inside plu.train.forward."""
    target = image(scene).reshape(-1, 3)
    step = sharded.make_train_step(scene, W, H, 1, loss_space="log", trainable=("mat_color",))
    params = sharded.get_params(scene)
    state = step.init(params)
    profiling.reset()
    with profiling.recording():
        step(params, state, target, rng.PRNGKey(3), 0)
    rec = profiling.recorded()
    entries = closed(rec)
    assert set(TRAIN_SPANS) <= set(rec["spans"])
    assert all(rec["spans"][s]["count"] == 1 for s in TRAIN_SPANS)
    (root,) = [e for e in entries if e.name == "plu.train.step"]
    assert root.parent is None and root.request is not None
    for e in entries:
        assert e.request == root.request
        if e.name in TRAIN_SPANS[1:] or e.name == "plu.render.keys":
            assert entries[e.parent] is root, e
        elif e is not root:  # the forward's draws, camera stage, radiance and table build
            assert e.name in RENDER_SPANS, e
            while entries[e.parent].name in RENDER_SPANS:
                e = entries[e.parent]
            assert entries[e.parent].name == "plu.train.forward", e
    assert {"plu.render.keys", "plu.render.draws", "plu.render.rays"} <= set(rec["spans"])


def test_generator_spans_close_before_yield(scene):
    """stratum_launches is a generator: at each of its yields no span of
    it is open."""
    px0 = renderer.pixel_centers(W, H)
    with profiling.recording():
        for _ in renderer.stratum_launches(scene, rng.PRNGKey(0), [(s, s) for s in range(3)],
                                           px0, N):
            assert all(e.end_ns for e in profiling.recorded()["entries"])
    assert profiling.recorded()["spans"]["plu.render.radiance"]["count"] == 3


def test_spans_nest_by_thread():
    """A span opened on another thread while one is open here starts
    without a parent (autograd runs backward functions on threads of its
    own)."""
    def other():
        with profiling.span("plu.x"):
            pass

    with profiling.recording():
        with profiling.span("plu.render", request=True):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with profiling.span("plu.y"):
                pass
    entries = profiling.recorded()["entries"]
    by = {e.name: e for e in entries}
    assert by["plu.x"].parent is None and by["plu.x"].request is None
    assert entries[by["plu.y"].parent].name == "plu.render"
    assert by["plu.y"].request == by["plu.render"].request


def test_counts_from_many_threads():
    """count() from more threads than cores, with a short switch interval:
    no update is lost."""
    threads, per = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            workers = [threading.Thread(target=lambda: [profiling.count("launches.k1")
                                                        for _ in range(per)])
                       for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counter("launches.k1") == threads * per

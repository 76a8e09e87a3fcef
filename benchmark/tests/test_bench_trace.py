"""The metric arithmetic on a canned profiler trace."""

from plubench import spec, work
from plubench.main import Context
from plubench.trace import WINDOW_SPAN, Event, gaps, reduce_events, union

MS = 1_000_000  # ns


def ev(kind, name, start_ms, end_ms, dev=False):
    return Event(kind, name, int(start_ms * MS), int(end_ms * MS), dev)


CANNED = [
    ev("user_annotation", WINDOW_SPAN, 0, 100),
    ev("user_annotation", "bench.render", 0, 80),
    ev("user_annotation", "bench.to_host", 80, 100),
    ev("cpu_op", "aten::add", 10, 12),
    ev("cpu_op", "aten::_to_copy", 85, 99),
    ev("cpu_op", "aten::copy_", 86, 98),
    ev("kernel", "megakernel", 5, 30, dev=True),
    ev("kernel", "closest_hit_ring", 20, 40, dev=True),  # overlaps the first
    ev("kernel", "megakernel", 50, 70, dev=True),
    ev("gpu_memcpy", "Memcpy DtoH", 90, 95, dev=True),
    ev("gpu_user_annotation", "bench.render", 0, 80, dev=True),  # not device work
    ev("kernel", "late", 120, 130, dev=True),  # outside the window
]


class Loop:
    kind = "render"
    times = [0.05, 0.05]
    spans = {"scene_compile": 0.25}
    least_s = 0.006


def test_union_and_gaps():
    cov = union([(5, 30), (20, 40), (50, 70), (-5, 2), (95, 120)], 0, 100)
    assert cov == [(0, 2), (5, 40), (50, 70), (95, 100)]
    assert gaps(cov, 0, 100) == [(2, 5), (40, 50), (70, 95)]


def test_reduce_canned_trace():
    r = reduce_events(CANNED)
    assert abs(r.window_s - 0.1) < 1e-12
    assert abs(r.busy_s - 0.06) < 1e-12  # 5-40, 50-70, 90-95
    assert r.launches == 3
    assert abs(r.idle_share - 0.4) < 1e-12
    assert r.device_ops[0][0] == "megakernel" and abs(r.device_ops[0][1] - 0.045) < 1e-12
    idle = dict(r.idle_gaps)
    # each gap goes whole to what the host did at its middle: 0-5 and 40-50
    # in render (python between operators), 70-90 at 80 in the copy's span
    # before its operator, 95-100 in the copy's operator
    assert abs(idle["render/python"] - 0.015) < 1e-12
    assert abs(idle["to_host/python"] - 0.020) < 1e-12
    assert abs(idle["to_host/aten::_to_copy"] - 0.005) < 1e-12
    assert abs(sum(idle.values()) - 0.04) < 1e-12


def test_readers_on_canned_trace():
    ctx = Context(Loop(), reduce_events(CANNED))
    got = {m: spec.metric_reader(m)(ctx) for m in
           ("launches_per_image", "device_idle_pct.render", "render_kernels_roofline",
            "scene_compile_ms")}
    assert got["launches_per_image"] == 1.5
    assert abs(got["device_idle_pct.render"] - 40.0) < 1e-9
    assert abs(got["render_kernels_roofline"] - 10.0) < 1e-9
    assert abs(got["scene_compile_ms"] - 250.0) < 1e-9


def test_readers_find_nothing_without_a_trace():
    ctx = Context(Loop(), None)
    for m in ("launches_per_image", "device_idle_pct.render", "render_kernels_roofline"):
        assert spec.metric_reader(m)(ctx) is None
    assert reduce_events([ev("kernel", "k", 1, 2, dev=True)]) is None


def test_least_time_is_the_largest_of_three():
    w = work.Work(fp32_ops=67e12, int32_ops=0.0, bytes=3.35e12 * 2)
    assert w.least_s() == 2.0
    w = work.Work(fp32_ops=0.0, int32_ops=work.INT32_OPS_PER_S * 3, bytes=0.0)
    assert abs(w.least_s() - 3.0) < 1e-12

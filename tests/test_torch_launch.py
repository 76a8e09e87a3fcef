"""Every kernel launch runs on its tensors' card (ops/cuda/build.on_device).

The kernels' wrappers are driven here on the CPU, without a card: their
tensors are CPU tensors that report a CUDA device (``CudaLike``, made by
the ``HostAsCard`` function mode from any factory or ``.to`` call that
names a CUDA device; ``pin_memory`` makes a stand-in for pinned memory,
whose copies are recorded), ``build.load`` returns a fake library that records
each C call, and ``torch.cuda.device`` / ``torch.cuda.current_stream``
are replaced by recorders. Each wrapper must make the tensors' card the
current device before each of its C calls (K1's plan included) and hand
the launch that card's stream, while another card is current outside.
A source test checks that every C call under ops/cuda/ sits inside
``build.on_device`` and that nothing else there asks for a stream.
"""

import ast
import contextlib
import dataclasses
import pathlib

import pytest
import torch
from torch.overrides import TorchFunctionMode

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.cuda import build, camera_kernel, integrator_kernel, intersect_kernel
from plutracer_tpu_torch.ops.cuda import rng_kernel, row_grad_kernel
from plutracer_tpu_torch.ops.cuda import stream_kernel
from plutracer_tpu_torch.ops.tables import pack_tables
from plutracer_tpu_torch.render.integrator import draw_uniforms, kernel_tier
from plutracer_tpu_torch.render.renderer import pixel_centers
from plutracer_tpu_torch.render.wavefront import Wave
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from plutracer_tpu_torch.utils import profiling
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
CUDA_DIR = REPO / "plutracer_tpu_torch" / "ops" / "cuda"
CARD = torch.device("cuda", 1)  # where the tensors report they lie
OTHER = torch.device("cuda", 0)  # the current device outside the launches


class CudaLike(torch.Tensor):
    """A CPU tensor that reports itself on CARD."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return CARD


def _names_cuda(x) -> bool:
    return isinstance(x, (str, torch.device)) and torch.device(x).type == "cuda"


class Pinned(torch.Tensor):
    """A CPU tensor that stands for one in pinned host memory."""


class HostAsCard(TorchFunctionMode):
    """Factories and .to() that name a CUDA device make CudaLike tensors
    on the CPU instead; pin_memory() makes a Pinned copy, and each copy_
    from one is kept in `copies` as (destination, source, non_blocking)."""

    def __init__(self):
        super().__init__()
        self.copies = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.Tensor.pin_memory:
            return args[0].clone().as_subclass(Pinned)
        if func is torch.Tensor.copy_ and isinstance(args[1], Pinned):
            self.copies.append((args[0], args[1], kwargs.get("non_blocking", False)))
            args = (args[0], args[1].as_subclass(torch.Tensor), *args[2:])
        moved = _names_cuda(kwargs.get("device"))
        if moved:
            kwargs["device"] = "cpu"
        if func is torch.Tensor.to:
            moved = moved or any(_names_cuda(a) for a in args[1:])
            args = tuple("cpu" if _names_cuda(a) else a for a in args)
        out = func(*args, **kwargs)
        if moved and isinstance(out, torch.Tensor) and not isinstance(out, CudaLike):
            out = out.as_subclass(CudaLike)
        return out


class Cards:
    """Stand-ins for torch.cuda.device and torch.cuda.current_stream: a
    stack of entered devices over OTHER, and a stream handle a device."""

    def __init__(self):
        self.stack = [OTHER]

    @property
    def current(self):
        return self.stack[-1]

    @contextlib.contextmanager
    def device(self, dev):
        self.stack.append(torch.device(dev))
        try:
            yield
        finally:
            self.stack.pop()

    def current_stream(self, dev=None):
        dev = self.current if dev is None else torch.device(dev)
        return type("Stream", (), {"cuda_stream": 1000 + dev.index})()


class FakeLibrary:
    """Records (name, current device, last argument) of each C call; the
    plan splits the table in two, so K1's split buffers are made too."""

    def __init__(self, cards):
        self.cards, self.calls = cards, []

    def __getattr__(self, name):
        if not name.startswith("plu_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, self.cards.current, args[-1]))
            if name == "plu_closest_hit_plan":
                args[-1]._obj.value = 3
                return 2
            return 0

        return call


@pytest.fixture
def launch_env(monkeypatch):
    cards = Cards()
    lib = FakeLibrary(cards)
    monkeypatch.setattr(torch.cuda, "device", cards.device)
    monkeypatch.setattr(torch.cuda, "current_stream", cards.current_stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: cards.current.index)
    monkeypatch.setattr(build, "load", lambda: type("Lib", (), {"lib": lib})())
    monkeypatch.setattr(build, "_ARRIVALS", {})
    with HostAsCard():
        yield cards, lib


def _scene(name):
    s = compile_scene(load_scene_file(str(REPO / "scenes" / f"{name}.urn"), ["/res", "8x8"]),
                      device="cpu")
    px = pixel_centers(8, 8)
    o, d = generate_rays(s.camera, px, torch.zeros_like(px))
    u = draw_uniforms(rng.PRNGKey(0), 64, DEFAULT_OPTIONS.max_bounces, "cpu")
    return s.to(CARD), o.to(CARD), d.to(CARD), u.to(CARD)


def k1(name):
    s, o, d, _ = _scene(name)
    return intersect_kernel.closest_hit_cuda(s.prims_packed, o, d, s.packed_type_rows)


def k3_query(name):
    s, o, d, _ = _scene(name)
    return intersect_kernel.closest_hit_bvh_cuda(s, o, d)


def path_kernel(fn, debug):
    def run(name):
        s, o, d, u = _scene(name)
        return fn(s, o, d, u, DEFAULT_OPTIONS, debug=debug)
    return run


def k4(name):
    s, o, d, u = _scene(name)
    opts = dataclasses.replace(DEFAULT_OPTIONS, stream_wavefront=True)
    assert kernel_tier(s, opts) == "k4"
    wave = Wave.start(s, o, d, u, "none", opts.max_bounces)
    return stream_kernel.onebounce_cuda(s, pack_tables(s), wave, 0, None, opts)


def r1(_name):
    return rng.uniform_block([rng.PRNGKey(0), rng.PRNGKey(1)], 24, CARD)


def r1_words(_name):
    words = torch.tensor([[0, -1], [7, 2**31 - 1]], dtype=torch.int32).to(CARD)
    return rng_kernel.uniform_block_words(words, 24)


def r2_table(name):
    s, _, _, _ = _scene(name)
    table = torch.tensor([[2, 1, 2, 3, 4], [0, -5, 6, -7, 8]], dtype=torch.int32).to(CARD)
    return camera_kernel.camera_rays_table_cuda(s.camera, pixel_centers(8, 8).to(CARD), table, 2)


def g1(_name):
    idx = torch.arange(5000).remainder(7).to(CARD)  # two chunks: partials and arrivals
    return row_grad_kernel.row_grad_cuda(idx, torch.zeros(5000, 12).to(CARD), (7, 12))


def g1_sorted(_name):
    idx = torch.arange(5000).remainder(300).to(CARD)  # past a warp's slice; 20 tiles
    return row_grad_kernel.row_grad_cuda(idx, torch.zeros(5000, 12).to(CARD), (300, 12))


# (wrapper, scene, the C calls it makes in order)
WRAPPERS = {
    "K1": (k1, "demo-box", ["plu_closest_hit_plan", "plu_closest_hit"]),
    "K3 query": (k3_query, "demo-box", ["plu_closest_hit_bvh"]),
    "K2": (path_kernel(integrator_kernel.ray_color_cuda, False), "demo-box",
           ["plu_closest_hit_plan", "plu_closest_hit", "plu_megakernel"]),
    "K2 debug (K5)": (path_kernel(integrator_kernel.ray_color_cuda, True), "demo-box",
                      ["plu_closest_hit_plan", "plu_closest_hit", "plu_megakernel"]),
    "K3": (path_kernel(stream_kernel.ray_color_stream_cuda, False), "sphere-grid",
           ["plu_megakernel_stream"]),
    "K3 debug (K5)": (path_kernel(stream_kernel.ray_color_stream_cuda, True), "sphere-grid",
                      ["plu_megakernel_stream"]),
    "K4": (k4, "sphere-grid", ["plu_megakernel_onebounce"]),
    "R1": (r1, None, ["plu_threefry_uniform"]),
    "R1 words": (r1_words, None, ["plu_threefry_uniform"]),
    "R2 table": (r2_table, "dof", ["plu_camera_rays_table"]),
    "G1": (g1, None, ["plu_row_grad"]),
    "G1 sorted": (g1_sorted, None, ["plu_row_grad_sorted"]),
}


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_wrapper_launches_on_its_tensors_card(launch_env, kernel):
    """Each C call of each wrapper runs with the tensors' card current
    (cuda:1 while cuda:0 is current outside), a launch on that card's
    stream; one helper entry a launch, K1's plan inside its launch's."""
    cards, lib = launch_env
    fn, scene, want = WRAPPERS[kernel]
    with profiling.recording():
        entries = profiling.counter("device_entries")
        fn(scene)
        entries = profiling.counter("device_entries") - entries
    assert [name for name, _, _ in lib.calls] == want
    for name, current, last in lib.calls:
        assert current == CARD, (name, current)
        if name != "plu_closest_hit_plan":
            assert last == 1000 + CARD.index, (name, last)  # CARD's stream
    assert cards.stack == [OTHER]  # left as it was found
    assert entries == len(want) - want.count("plu_closest_hit_plan")


def test_k1_arrivals_one_buffer_a_card(launch_env):
    """The arrival counts of K1 and G1 (build.arrivals) are kept by device
    index and stream: "cuda" (the current card) and its explicit index
    share one buffer, another card has its own."""
    cards, _ = launch_env
    with cards.device(CARD):
        a = build.arrivals(torch.device("cuda"), 8, 7)
    b = build.arrivals(CARD, 8, 7)
    c = build.arrivals(OTHER, 8, 7)
    d = build.arrivals(CARD, 8, 9)  # another stream
    assert a is b and c is not a and d is not a
    assert set(build._ARRIVALS) == {(CARD.index, 7), (OTHER.index, 7), (CARD.index, 9)}


def test_on_device_refuses_the_cpu():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        with build.on_device("cpu"):
            pass


def _parents(tree):
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _inside_on_device(node, parents):
    while node in parents:
        node = parents[node]
        if isinstance(node, ast.With) and any(
                isinstance(item.context_expr, ast.Call)
                and getattr(item.context_expr.func, "attr", None) == "on_device"
                for item in node.items):
            return True
    return False


def test_every_c_call_inside_the_launch_helper():
    """Under ops/cuda/, every call of a kernel library function (plu_*)
    sits inside a ``with build.on_device(...)`` block, and only the
    helper asks torch for a stream."""
    c_calls = 0
    for path in sorted(CUDA_DIR.glob("*.py")):
        tree = ast.parse(path.read_text())
        parents = _parents(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            if node.attr == "current_stream":
                scopes, scope = [], node
                while scope in parents:
                    scope = parents[scope]
                    if isinstance(scope, (ast.ClassDef, ast.FunctionDef)):
                        scopes.append(scope.name)
                assert path.name == "build.py" and "on_device" in scopes, (
                    f"{path.name}:{node.lineno} asks for a stream outside build.on_device")
            elif node.attr.startswith("plu_") and isinstance(parents.get(node), ast.Call):
                c_calls += 1
                assert _inside_on_device(node, parents), (
                    f"{path.name}:{node.lineno}: {node.attr} called outside build.on_device")
    # K1's plan and launch, the K3 query, K2, K3, K4, R1, R2, G1 and its sorted kernel
    assert c_calls == len(build._SIGNATURES) == 10

"""``train``: inverse-rendering steps on one card.

A closed loop of steps through the program's
``parallel.sharded.make_train_step`` (on the 1x1 mesh of the card), driven
by ``step.many`` in chunks of ``chunk`` steps, each chunk's losses copied
to the host, as optimize_scene does. Every step renders one stratified
pass (two for the "ab" loss) of the whole image at ``n``.

Set-up renders the target through the program (``render`` of the true
parameters at ``target_n``, keyed from the seed), starts the parameters
where the flagship does (the diffuse materials' albedo at
``start_albedo``, the emission times ``start_emission``) and drives the
step through its first ``checked_steps`` steps with the window's own call
(one step, then the rest): the warm-up, and what the reference follows
from the start. The window goes on from there with the same step,
parameters and optimiser state, and keeps the parameters and optimiser
state before its last chunk, which the reference replays.

Parameters (the configuration's, a mix's on top): width, height, n,
target_n, chunk, checked_steps, check_pixels (the target's pixels the
check replays), loss_space ("log", "linear" or "ab"), loss_downsample,
loss_clamp, project_nonnegative, trainable (the fields updated), labels
(every differentiable field's optimiser label), optimizers (label -> {lr,
and decay_steps with decay_rate for an exponential decay}), start_albedo,
start_emission.

What decides correct (``numbers``), with the program's state freed first:

- ``tables_off``: the scene tables against the reference's compile;
- ``target_rel_l1``, ``target_pixels_off``: the program's target at
  check_pixels pixels drawn from the seed against the reference's
  (check.pixel_numbers): the reference's steps start from the program's
  target, so it is checked on its own;
- ``loss_gap``: the worst relative gap of the checked steps' losses
  against the reference's steps from the same start;
- ``grad_gap``: the first gradient as Adam got it (its first moment after
  step 0), ``change_gap``: the parameters' change over the checked steps
  (check.leaf_gaps, over the leaves whose reference gradient is at least
  LEAF_FLOOR of the median leaf's);
- ``last_loss_gap``, ``last_change_gap``, ``last_moments_gap``: the
  window's last chunk, replayed by the reference from the program's
  parameters and optimiser state before it: its losses, the parameters'
  change over it and Adam's two moments after it (the worst of mu's and
  nu's leaf gaps).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from plubench import check, spec
from plubench.traffic import sync

LIMITS = {"tables_off": 0.0, "target_rel_l1": 2e-3, "target_pixels_off": 0.1,
          "loss_gap": 6e-4, "grad_gap": 2.5e-3, "change_gap": 1e-3,
          "last_loss_gap": 6e-4, "last_change_gap": 1e-3, "last_moments_gap": 2.5e-3}
# the item indices of a run's target key and its steps' key
TARGET_ITEM, STEP_ITEM = 0xFFFFFFFE, 0xFFFFFFFD
# a leaf whose reference gradient is under this share of the median leaf's
# is left out of the leaf gaps (Adam moves it by round-off alone)
LEAF_FLOOR = 1e-3


def make_optimizer(optim, optimizers: dict, labels: dict):
    """A multi-transform of Adams from `optim` (the program's diff.optim or
    the reference's: the same interface), one a label."""
    def rate(o):
        if "decay_steps" in o:
            return optim.exponential_decay(float(o["lr"]), int(o["decay_steps"]),
                                           float(o["decay_rate"]))
        return float(o["lr"])

    return optim.MultiTransform({label: optim.Adam(rate(o)) for label, o in optimizers.items()},
                                labels)


def to(tree, device):
    """A copy of an optimiser state or a dict of tensors on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device).clone()
    if isinstance(tree, dict):
        return {k: to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to(v, device) for v in tree)
    return copy.deepcopy(tree)


class Loop:
    kind = "train"

    def __init__(self, cell: spec.Cell, seed: int, device, tracer):
        self.cell, self.seed, self.device, self.tracer = cell, seed, torch.device(device), tracer
        p = cell.params
        self.width, self.height = int(p["width"]), int(p["height"])
        self.n, self.target_n = int(p["n"]), int(p["target_n"])
        self.chunk, self.checked = int(p["chunk"]), int(p["checked_steps"])
        self.check_pixels = int(p["check_pixels"])
        self.loss = dict(loss_space=str(p.get("loss_space", "log")),
                         loss_downsample=int(p.get("loss_downsample", 1)),
                         loss_clamp=float(p.get("loss_clamp", 0.0)),
                         project_nonnegative=bool(p.get("project_nonnegative", False)))
        self.trainable = tuple(p["trainable"])
        self.labels = dict(p["labels"])
        self.optimizers = dict(p["optimizers"])
        self.start_albedo = float(p["start_albedo"])
        self.start_emission = float(p["start_emission"])
        self.spans: Dict[str, float] = {}
        self.times: List[float] = []  # seconds a step
        self.attempted = self.failed = 0
        self.window_s = 0.0
        self.least_s = None
        self.last = None  # (start, params, state) before the window's last chunk

    def _key(self, salt: int) -> torch.Tensor:
        return torch.tensor(check.item_words(self.seed, salt), dtype=torch.int64)

    def setup(self) -> None:
        from plutracer_tpu_torch.diff import optim
        from plutracer_tpu_torch.parallel.sharded import make_train_step
        from plutracer_tpu_torch.render.renderer import render
        from plutracer_tpu_torch.scene import compile_scene, load_scene_file

        t0 = time.perf_counter()
        desc = load_scene_file(str(spec.scene_file(self.cell.config)),
                               ["/res", f"{self.width}x{self.height}"])
        scene = compile_scene(desc, device=self.device)
        sync(self.device)
        self.spans["scene_compile"] = time.perf_counter() - t0
        self.target = render(scene, self.width, self.height, self.target_n,
                             self._key(TARGET_ITEM))
        params0, mask = perturbed_params(scene, self.start_albedo, self.start_emission)
        opt = make_optimizer(optim, self.optimizers, self.labels)
        self.step = make_train_step(scene, self.width, self.height, self.n, optimizer=opt,
                                    trainable=self.trainable, grad_mask=mask, **self.loss)
        self.target_flat = self.target.reshape(-1, 3)
        self.key0 = self._key(STEP_ITEM)
        state = self.step.init(params0)
        self.params0 = to(params0, "cpu")
        # the checked steps, through the window's call: one, then the rest
        params, state, loss1, _ = self.step.many(params0, state, self.target_flat, self.key0, 0, 1)
        self.mu1 = to(adam_mu(state), "cpu")
        params, state, loss_rest, _ = self.step.many(params, state, self.target_flat, self.key0,
                                                     1, self.checked - 1)
        self.losses = torch.cat([loss1, loss_rest]).double().cpu()
        self.params_checked = to(params, "cpu")
        self.params, self.state, self.next_step = params, state, self.checked
        self.scene = scene
        sync(self.device)

    def run(self, seconds: float) -> None:
        w0 = time.perf_counter()
        end = w0
        while time.perf_counter() - w0 < seconds:
            self.attempted += self.chunk
            t0 = time.perf_counter()
            before = (self.next_step, to(self.params, self.device), to(self.state, self.device))
            with self.tracer.span("steps"):
                self.params, self.state, losses, _ = self.step.many(
                    self.params, self.state, self.target_flat, self.key0, self.next_step,
                    self.chunk)
            with self.tracer.span("to_host"):
                self.last_losses = losses.double().cpu()
            end = time.perf_counter()
            self.last = before
            self.next_step += self.chunk
            self.times.extend([(end - t0) / self.chunk] * self.chunk)
        self.window_s = end - w0

    def end_to_end(self) -> Dict[str, float]:
        return {"train_step_ms": 1e3 * self.window_s / len(self.times)}

    def check(self, count_work: bool) -> List[check.Compared]:
        """The numbers that decide correct, with the program's state freed
        before the reference runs."""
        pix = check.sample_pixels(self.seed, self.width, self.height, self.check_pixels)
        target = self.target.cpu()
        last = None
        if self.last is not None:
            start, params, state = self.last
            last = LastChunk(start=start, params=to(params, "cpu"), state=to(state, "cpu"),
                             params_after=to(self.params, "cpu"),
                             state_after=to(self.state, "cpu"), losses=self.last_losses)
        prog = ProgramSteps(target=target,
                            target_pixels=target.reshape(-1, 3)[torch.as_tensor(pix)],
                            losses=self.losses, params0=self.params0, mu1=self.mu1,
                            params_checked=self.params_checked, scene=self.scene.to("cpu"),
                            last=last)
        self.step = self.params = self.state = self.scene = self.target = None
        self.target_flat = self.last = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return check.judged(numbers(prog, self, self.device), LIMITS)


def perturbed_params(scene, albedo: float, emission: float):
    """(parameters, gradient mask) of the flagship's start from a compiled
    scene (the program's or the reference's): every differentiable field
    as it is, the diffuse materials' albedo at `albedo` and the emission
    times `emission`; the mask freezes every material that is not
    diffuse."""
    from plubench.reference.scene.types import MAT_DIFFUSE
    from plubench.reference.train import FIELDS

    params = {f: getattr(scene, f).detach().clone() for f in FIELDS}
    diffuse = scene.mat_type == MAT_DIFFUSE
    params["mat_color"][diffuse] = albedo
    params["light_intensity"] = params["light_intensity"] * torch.tensor(
        emission, dtype=torch.float32, device=scene.mat_type.device)
    return params, {"mat_color": diffuse.to(torch.float32)[:, None]}


def adam_mu(state) -> Dict[str, torch.Tensor]:
    """Adam's first moments by field, from an optimiser state (an Adam
    state, or a multi-transform's states of Adams)."""
    return adam_moment(state, "mu")


def adam_moment(state, which: str) -> Dict[str, torch.Tensor]:
    if hasattr(state, "inner_states"):
        out = {}
        for inner in state.inner_states.values():
            out.update(adam_moment(inner, which))
        return out
    return dict(getattr(state, which))


@dataclasses.dataclass
class LastChunk:
    """The window's last chunk: its first step, the parameters and
    optimiser state before it and after it, and its losses."""
    start: int
    params: Dict[str, torch.Tensor]
    state: object
    params_after: Dict[str, torch.Tensor]
    state_after: object
    losses: torch.Tensor


@dataclasses.dataclass
class ProgramSteps:
    """What a train run kept of the program, on the host: its target and
    the target's sampled pixels, the checked steps' losses, the parameters
    before them and after them, Adam's first moments after the first, its
    scene and the window's last chunk (None where the window completed no
    step)."""
    target: torch.Tensor
    target_pixels: torch.Tensor
    losses: torch.Tensor
    params0: Dict[str, torch.Tensor]
    mu1: Dict[str, torch.Tensor]
    params_checked: Dict[str, torch.Tensor]
    scene: object
    last: object = None


def reference_optimizer(loop):
    from plubench.reference.diff import optim

    return make_optimizer(optim, loop.optimizers, loop.labels)


def reference_loss(loop):
    from plubench.reference.train import Loss

    return Loss(space=loop.loss["loss_space"], downsample=loop.loss["loss_downsample"],
                clamp=loop.loss["loss_clamp"],
                project_nonnegative=loop.loss["project_nonnegative"])


def reference_steps(ref_scene, target_flat, loop, params, state, start: int, k: int,
                    bf16: bool = False):
    """(losses, the first step's gradients, Adam's first moments after the
    first step, parameters and state after) of k reference steps from
    step `start`, parameters and optimiser state (the reference's)."""
    from plubench.reference import train

    opt = reference_optimizer(loop)
    _, mask = perturbed_params(ref_scene, loop.start_albedo, loop.start_emission)
    key0 = check.item_words(loop.seed, STEP_ITEM)
    losses, grads1, mu1 = [], None, None
    for i in range(start, start + k):
        params, state, loss, grads = train.step(
            ref_scene, params, state, opt, target_flat, key0, i, loop.width, loop.height,
            loop.n, loop.trainable, mask, loss=reference_loss(loop), bf16=bf16)
        losses.append(float(loss))
        if i == start:
            grads1, mu1 = grads, adam_mu(state)
    return losses, grads1, mu1, params, state


def reference_state(loop, program_state, params, device):
    """The reference optimiser's state holding the program's state's
    leaves (read by name: count, mu, nu, inner_states)."""
    opt = reference_optimizer(loop)
    leaves = [x.to(device) for x in opt.state_leaves(program_state)]
    state, rest = opt.state_from_leaves(opt.init(params), leaves)
    if rest:
        raise ValueError(f"the program's optimiser state has {len(rest)} leaves more than "
                         f"the reference's")
    return state


def counted_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose gradient norm is at least LEAF_FLOOR of the median
    leaf's."""
    norms = {f: float(g.double().norm()) for f, g in grads.items()}
    med = float(np.median(list(norms.values())))
    return [f for f in norms if norms[f] >= LEAF_FLOOR * med]


def rel_gap(got, ref) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, ref))


def numbers(prog: ProgramSteps, loop, device) -> Dict[str, float]:
    """A train run's numbers (the module's docstring)."""
    ref_scene = check.reference_scene(spec.scene_file(loop.cell.config), loop.width,
                                      loop.height, device)
    values = {"tables_off": check.tables_off(prog.scene, ref_scene)}
    pix = check.sample_pixels(loop.seed, loop.width, loop.height, loop.check_pixels)
    tgt = check.reference_pixels(ref_scene, loop.width, loop.height, loop.target_n,
                                 check.item_words(loop.seed, TARGET_ITEM), pix)
    got = prog.target_pixels
    img = check.pixel_numbers(got, torch.zeros_like(got), tgt)
    values["target_rel_l1"], values["target_pixels_off"] = img["linear_rel_l1"], img["pixels_off"]
    target_flat = prog.target.reshape(-1, 3).to(device)
    params0, _ = perturbed_params(ref_scene, loop.start_albedo, loop.start_emission)
    state0 = reference_optimizer(loop).init(params0)
    losses, grads1, mu1, params, _ = reference_steps(ref_scene, target_flat, loop, params0,
                                                     state0, 0, loop.checked)
    counted = counted_leaves(mu1)
    values["loss_gap"] = rel_gap(prog.losses.tolist(), losses)
    values["grad_gap"] = check.leaf_gaps(prog.mu1, mu1, counted)
    change_r = {f: params[f] - params0[f] for f in params}
    change_p = {f: prog.params_checked[f].to(device) - prog.params0[f].to(device)
                for f in params}
    values["change_gap"] = check.leaf_gaps(change_p, change_r, counted)
    last = prog.last
    if last is None:
        values.update(last_loss_gap=float("nan"), last_change_gap=float("nan"),
                      last_moments_gap=float("nan"))
        return values
    p_before = {f: v.to(device) for f, v in last.params.items()}
    s_before = reference_state(loop, last.state, p_before, device)
    losses, grads, _, params, state = reference_steps(ref_scene, target_flat, loop, p_before,
                                                      s_before, last.start, len(last.losses))
    counted = counted_leaves(grads)
    values["last_loss_gap"] = rel_gap(last.losses.tolist(), losses)
    change_r = {f: params[f] - p_before[f] for f in params}
    change_p = {f: last.params_after[f].to(device) - p_before[f] for f in params}
    values["last_change_gap"] = check.leaf_gaps(change_p, change_r, counted)
    values["last_moments_gap"] = max(
        check.leaf_gaps(adam_moment(last.state_after, m), adam_moment(state, m), counted)
        for m in ("mu", "nu"))
    return values


def control_steps(prog: ProgramSteps, loop, device) -> ProgramSteps:
    """The train check's control: the reference computed in bfloat16 in the
    program's place (its scene tables rounded, each pass's radiance rounded
    before the loss, the target's pixels rounded), its steps run from the
    program's target as the reference's are, and the last chunk replayed
    from the program's state before it."""
    ref_scene = check.round_scene(check.reference_scene(spec.scene_file(loop.cell.config),
                                                        loop.width, loop.height, device))
    pix = check.sample_pixels(loop.seed, loop.width, loop.height, loop.check_pixels)
    tgt = check.reference_pixels(ref_scene, loop.width, loop.height, loop.target_n,
                                 check.item_words(loop.seed, TARGET_ITEM), pix, bf16=True)
    target_flat = prog.target.reshape(-1, 3).to(device)
    params0, _ = perturbed_params(ref_scene, loop.start_albedo, loop.start_emission)
    state0 = reference_optimizer(loop).init(params0)
    losses, _, mu1, params, _ = reference_steps(ref_scene, target_flat, loop, params0, state0,
                                                0, loop.checked, bf16=True)
    last = None
    if prog.last is not None:
        p_before = {f: v.to(device) for f, v in prog.last.params.items()}
        s_before = reference_state(loop, prog.last.state, p_before, device)
        l_losses, _, _, l_params, l_state = reference_steps(
            ref_scene, target_flat, loop, p_before, s_before, prog.last.start,
            len(prog.last.losses), bf16=True)
        last = LastChunk(start=prog.last.start, params=prog.last.params, state=prog.last.state,
                         params_after=l_params, state_after=l_state,
                         losses=torch.tensor(l_losses, dtype=torch.float64))
    return ProgramSteps(target=prog.target, target_pixels=tgt.cpu(),
                        losses=torch.tensor(losses, dtype=torch.float64),
                        params0=params0, mu1=mu1, params_checked=params, scene=ref_scene,
                        last=last)

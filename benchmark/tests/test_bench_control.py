"""The control: the reference in the program's place, computed in
bfloat16 (check.control_numbers, traffic/train.py's control_steps), fails the check's
limits: on the CPU at a tiny size, and (marked cuda) at each cell's own
size on three seeds, printing its readings (a train cell's beside the
program's own, in one process)."""

import pytest
import torch

from helpers import SPEC, tiny_cell, tiny_train
from plubench import check, spec, traffic
from plubench.trace import Tracer

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def control_fails(cell, seed, device):
    cfg = cell.config
    W, H, n = int(cfg["width"]), int(cfg["height"]), int(cfg["n"])
    pix = check.sample_pixels(seed, W, H, int(cfg["check_pixels"]))
    values = check.control_numbers(spec.scene_file(cfg), W, H, n, check.item_words(seed, 0),
                                   pix, device)
    compared = check.judged(values, check.RENDER_LIMITS)
    print(f"control {cell.name} seed {seed}: " + ", ".join(
        f"{c.name} {c.value!r} (limit {c.limit!r})" for c in compared))
    return [c.name for c in compared if not c.ok]


@pytest.mark.parametrize("name", ["cornell-box.final", "spd-tetra.final"])
def test_control_fails_on_cpu(name):
    cell = tiny_cell(name, size=8, n=2, pixels=16)
    failed = control_fails(cell, SEEDS[0], "cpu")
    assert failed


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["cornell-box.final", "spd-tetra.final"])
def test_control_fails_at_cell_size(name, seed, cuda_device):
    failed = control_fails(spec.find_cell(name, SPEC), seed, cuda_device)
    assert failed


def train_readings(cell, seed, device, seconds=1.0):
    """(the program's numbers, the control's) of a train cell's set-up and
    a short window."""
    train = spec.traffic_module("train")
    loop = traffic.make_loop(cell, seed, device, Tracer(False))
    loop.setup()
    loop.run(seconds)
    keep = {}
    real = train.numbers

    def kept(prog, lp, dev):
        keep["prog"] = prog
        return real(prog, lp, dev)
    train.numbers = kept
    got = loop.check(False)
    prog = keep["prog"]
    ctl = check.judged(train.numbers(train.control_steps(prog, loop, device), loop, device),
                       train.LIMITS)
    for who, compared in (("program", got), ("control", ctl)):
        print(f"{who} {cell.name} seed {seed}: " + ", ".join(
            f"{c.name} {c.value!r} (limit {c.limit!r})" for c in compared))
    return got, ctl


def test_train_control_fails_on_cpu():
    got, ctl = train_readings(tiny_train(), SEEDS[0], torch.device("cpu"))
    assert all(c.ok for c in got)
    assert any(not c.ok for c in ctl if c.name != "tables_off")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_train_control_fails_at_cell_size(seed, cuda_device):
    got, ctl = train_readings(spec.find_cell("cornell-box.train", SPEC), seed, cuda_device)
    assert any(not c.ok for c in ctl)

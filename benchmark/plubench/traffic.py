"""What every traffic generator shares, and the generator of a cell.

A mix's file, ``traffic/<mix>.json``, gives its ``kind`` and parameters;
``traffic/<kind>.py`` is the generator of every mix of that kind: a class
``Loop(cell, seed, device, tracer)`` with

- ``setup()``: load and compile the scene through the program, warm up
  every shape the window runs (set-up; its spans go in ``spans``);
- ``run(seconds)``: the measured window (sets ``window_s`` and ``times``,
  one entry an item: an image, a step);
- ``end_to_end()``: {metric: value} of the window;
- ``check(count_work)``: the numbers that decide correct (check.Compared),
  computed once the program's state is freed; count_work also sets
  ``least_s`` (work.py) where the kind counts it;

and the attributes ``kind``, ``attempted``, ``failed`` and ``least_s``.
Adding a kind is adding its file.
"""

from __future__ import annotations

from typing import List

import torch

from plubench import spec

WARMUP_KEY = 0xFFFFFFFF  # item index of the warm-up items' keys


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank q-th percentile."""
    xs = sorted(values)
    k = max(1, -(-len(xs) * q // 100))
    return xs[int(k) - 1]


def make_loop(cell: spec.Cell, seed: int, device, tracer):
    """The cell's generator, found by its mix's kind, set to the cell."""
    return spec.generator(cell.traffic["kind"], cell.folder)(cell, seed, device, tracer)

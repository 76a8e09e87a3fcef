"""Tiny cells of the real BENCHMARK.json, run on the CPU."""

import pathlib
import tempfile
import time

import torch

from plubench import spec
from plubench.main import run_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = ROOT / "BENCHMARK.json"
SEED = 2**31 + 7  # above 32 signed bits, as a check's seeds may be


_SMALL = {}


def small_tetra(level=2):
    """tetra.urn over the SPD tetra at `level` (4^level tetrahedra), written
    once a process under TMPDIR: the CPU's brute-force queries over the
    cell's 65,536 triangles take minutes."""
    if level not in _SMALL:
        folder = pathlib.Path(tempfile.mkdtemp(prefix="plubench-tetra"))
        make = spec._load(spec.HERE / "scenes" / "make_scenes.py", "plubench_scenes")
        make.write_obj(folder / "tetra7.obj", "test tetra", make.tetra(level))
        (folder / "tetra.urn").write_text((spec.HERE / "scenes" / "tetra.urn").read_text())
        _SMALL[level] = folder / "tetra.urn"
    return _SMALL[level]


def tiny_cell(name, size=8, n=1, pixels=16):
    """The cell `name` of BENCHMARK.json at size x size, n, with `pixels`
    checked (the tetra cell over a small tetra)."""
    cell = spec.find_cell(name, SPEC)
    cell.config.update(width=size, height=size, n=n, check_pixels=pixels)
    if cell.config["name"] == "spd-tetra":
        cell.config["scene"] = str(small_tetra())
    return cell


def run_tiny(cell, seconds=0.3, trace=False, seed=SEED):
    return run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())


def tiny_train(size=8, n=2, target_n=2, pixels=16, **mix):
    """cornell-box.train at size x size on the CPU, its target at target_n
    (mix: more of the mix's parameters changed)."""
    cell = spec.find_cell("cornell-box.train", SPEC)
    cell.config.update(width=size, height=size)
    cell.traffic.update(n=n, target_n=target_n, check_pixels=pixels, **mix)
    return cell

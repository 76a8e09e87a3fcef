"""One run of one cell: set-up, the measured window, the check, one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The run needs as
many CUDA cards as the cell asks for (it never falls back to the CPU:
without them it exits 3 and prints no result). It sets up the cell's
traffic (plubench/traffic.py), measures for --seconds, checks the outputs
against the frozen reference (plubench/check.py) once the program's state
is freed, and prints as its last line of standard output

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "checks"}

with the cell's end-to-end metrics (--trace 0) or its per-layer metrics
(--trace 1, the window under torch.profiler), and each number compared
beside its limit, also as the last lines of standard error. It exits 4,
with no result, where jax, jaxlib, flax or the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "plutracer_tpu")
THREADS = 1  # torch's host threads: one measured steadier and faster than two (PERF.md §2)
NAME_CHARS = 160  # a breakdown entry's name is cut there (kernel names carry their templates)


def forbidden_modules():
    """The loaded modules whose top-level name, compared whole, is jax,
    jaxlib, flax or the JAX package."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit_w():
    """The card's power limit as nvidia-smi reports it (None where it
    cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Context:
    """What a per-layer metric's reader reads (metrics/<name>.py)."""

    def __init__(self, loop, reduced):
        self.kind = loop.kind  # the traffic's generator: "render"
        self.items = len(loop.times)  # images completed in the window
        self.spans = dict(loop.spans)  # set-up spans, seconds
        self.trace = reduced  # trace.Reduced of the window, or None
        self.least_s = loop.least_s  # work.py's least time of the window's work


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """(result dict, compared numbers) of one run of `cell` on `device`."""
    import torch

    from plubench import spec
    from plubench.trace import Tracer
    from plubench.traffic import make_loop

    tracer = Tracer(trace)
    loop = make_loop(cell, seed, device, tracer)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    with tracer.window():
        loop.run(seconds)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t_check = time.perf_counter()
    compared = loop.check(count_work=trace)
    print(f"run.py: set-up {setup_s:.3f} s, window {loop.window_s:.3f} s "
          f"({len(loop.times)} items), check {time.perf_counter() - t_check:.3f} s; "
          f"item ms in order: {' '.join(f'{1e3 * t:.1f}' for t in loop.times)}",
          file=sys.stderr)
    if trace:
        reduced = tracer.reduced()
        metrics = spec.read_metrics(cell.per_layer, Context(loop, reduced), cell.folder)
    else:
        reduced = None
        values = {**loop.end_to_end(), "setup_s": setup_s}
        units = {m.name: m.unit for m in cell.end_to_end}
        metrics = {k: {"value": float(values[k]), "unit": units[k]} for k in units}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w() if cuda else None}
    result = {"correct": all(c.ok for c in compared), "attempted": loop.attempted,
              "failed": loop.failed, "metrics": metrics, "device": dev}
    if reduced is not None:
        dev.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        result["breakdown"] = {"device_ops": [[k[:NAME_CHARS], v] for k, v in reduced.device_ops],
                               "idle_gaps": [[k[:NAME_CHARS], v] for k, v in reduced.idle_gaps]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    return result, compared


def main(argv, t_start: float) -> int:
    args = parse(argv)
    from plubench import spec

    spec_path = pathlib.Path.cwd() / "BENCHMARK.json"
    cell = spec.find_cell(args.workload, spec_path)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 3
    torch.set_num_threads(THREADS)
    result, compared = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda:0"), t_start)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded once the window closed: {', '.join(found)}", file=sys.stderr)
        return 4
    for c in compared:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

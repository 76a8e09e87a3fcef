"""Profiling and metrics.

The port of plutracer_tpu/utils/profiling.py:

- ``PhaseTimer``: wall-clock phase timing (the reference's init / render /
  postprocess prints, src/main.cpp:146-204) with a structured report.
- ``RenderStats``: samples/s and issued rays/s derived from the image
  shape and the integrator's worst-case query count.
- ``profile_trace``: a torch.profiler trace (the host, and CUDA once a
  card is in use) of the enclosed block, written into a directory as a
  Chrome trace (the CLI's /profile).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict

import torch


class PhaseTimer:
    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "\n".join(f"{k} took: {int(v * 1000)}ms" for k, v in self.phases.items())

    def as_json(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.phases.items()})


@dataclasses.dataclass
class RenderStats:
    """Throughput accounting for one render.

    A sample is a full camera path. Each of its max_bounces shading
    vertices issues at most 3 closest-hit queries (the extension ray and
    the two NEE visibility rays, renderer.cpp:16,41,86), so a sample
    issues at most 3 * max_bounces.
    """

    width: int
    height: int
    spp: int
    seconds: float
    max_bounces: int = 8

    @property
    def samples(self) -> int:
        return self.width * self.height * self.spp

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.seconds, 1e-12)

    @property
    def rays_per_sec_upper(self) -> float:
        return self.samples_per_sec * 3 * self.max_bounces

    def report(self) -> str:
        return (
            f"{self.samples} samples in {self.seconds:.2f}s = "
            f"{self.samples_per_sec / 1e6:.2f} Msamples/s "
            f"(<= {self.rays_per_sec_upper / 1e6:.1f} Mrays/s issued)"
        )


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler trace of the enclosed block, written into the
    directory `log_dir` (made if missing), as the JAX package's
    profile_trace(log_dir) writes its device trace there.
    torch.profiler.tensorboard_trace_handler names the file
    ``<host>_<pid>.<ns>.pt.trace.json``, so traces of one directory
    accumulate (a Chrome trace, which TensorBoard's profiler plugin also
    reads). The host is always recorded; CUDA too whenever a card is
    initialised in this process."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof

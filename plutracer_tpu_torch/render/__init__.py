"""Integrator and render drivers.

Drivers, least to most machinery: ``render``/``render_image`` (one
process, one device), ``progressive.render_with_checkpoint`` (resumable
accumulation), ``elastic.render_elastic`` (strata over a device list),
``supervisor.supervise_render`` (worker subprocess, failure detection,
restarts). ``ray_color`` is the plain integrator.
"""

from plutracer_tpu_torch.render.integrator import ray_color
from plutracer_tpu_torch.render.renderer import render, render_image

__all__ = ["ray_color", "render", "render_image"]

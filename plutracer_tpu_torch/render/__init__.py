"""Integrator and render drivers.

Drivers, least to most machinery: ``render``/``render_image`` (one
process, one device), ``progressive.render_with_checkpoint`` (resumable
accumulation), ``elastic.render_elastic`` (strata over a device list),
``supervisor.supervise_render`` (worker subprocess, failure detection,
restarts). ``ray_color(scene, o, d, key, options, terms)`` is the JAX
package's integrator entry point: it draws the uniforms from the key and
runs the kernels on a card, the plain integrator
(``integrator.ray_color_plain``) on the CPU.
"""

from plutracer_tpu_torch.render.integrator import ray_color
from plutracer_tpu_torch.render.renderer import render, render_image

__all__ = ["ray_color", "render", "render_image"]

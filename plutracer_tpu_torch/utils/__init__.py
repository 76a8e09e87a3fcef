"""Utilities: profiling and render statistics."""

from plutracer_tpu_torch.utils.profiling import PhaseTimer, RenderStats, profile_trace

__all__ = ["PhaseTimer", "RenderStats", "profile_trace"]

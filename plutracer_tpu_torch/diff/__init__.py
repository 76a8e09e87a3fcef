"""Differentiable / inverse rendering: Adam (``optim``) and the fitting
loop (``optimize``: InverseRenderConfig, optimize_scene)."""

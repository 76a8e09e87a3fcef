"""Differentiable / inverse rendering: Adam (``optim``) and the fitting
loop (``optimize``: InverseRenderConfig, optimize_scene).

The fitting loop's names load on first use: ``optimize`` imports
``parallel.sharded``, which imports ``diff.optim`` and so this package.
"""

__all__ = ["InverseRenderConfig", "optimize_scene"]


def __getattr__(name):
    if name in __all__:
        from plutracer_tpu_torch.diff import optimize

        return getattr(optimize, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

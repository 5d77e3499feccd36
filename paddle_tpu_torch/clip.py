"""Gradient clipping — port of ``paddle_tpu/clip.py``.

Reference: ``python/paddle/fluid/clip.py`` — GradientClipByValue /
GradientClipByNorm / GradientClipByGlobalNorm, here transforms of the
``{name: gradient}`` dict that ``Optimizer.apply_gradients`` runs before
the update, and ErrorClipByValue, which clips the gradient flowing back
through one tensor. The norm clips take each gradient's squared norm from
``sq_norms`` (by default :func:`squared_norms`): where a rank holds blocks
of parameters split over a mesh axis, ``DataParallel`` passes one that sums
the blocks' over the axis, so every rank clips by the whole norms.
"""

from __future__ import annotations

from typing import Dict

import torch


def squared_norms(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each gradient's squared L2 norm, in f32."""
    return {k: torch.sum(torch.square(g.float())) for k, g in grads.items()}


class GradientClipBase:
    def __call__(self, grads: Dict[str, torch.Tensor], sq_norms=squared_norms
                 ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    def __init__(self, max: float, min: float | None = None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, grads, sq_norms=squared_norms):
        return {k: torch.clamp(g, self.min, self.max) for k, g in grads.items()}


class GradientClipByNorm(GradientClipBase):
    """Per-tensor L2-norm clip."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads, sq_norms=squared_norms):
        sq = sq_norms(grads)

        def clip_one(g, s):
            scale = torch.clamp(self.clip_norm / torch.clamp(torch.sqrt(s), min=1e-12), max=1.0)
            return (g.float() * scale).to(g.dtype)

        return {k: clip_one(g, sq[k]) for k, g in grads.items()}


class GradientClipByGlobalNorm(GradientClipBase):
    """Global-norm clip across every gradient."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads, sq_norms=squared_norms):
        norm = global_norm(grads, sq_norms)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


def global_norm(grads: Dict[str, torch.Tensor], sq_norms=squared_norms) -> torch.Tensor:
    return torch.sqrt(sum(sq_norms(grads).values()))


class _ErrorClip(torch.autograd.Function):
    """Identity forward; the incoming gradient is clipped to [min, max]."""

    @staticmethod
    def forward(ctx, x, max_, min_):
        ctx.bounds = (min_, max_)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, *ctx.bounds), None, None


def error_clip_by_value(x: torch.Tensor, max: float, min: float) -> torch.Tensor:
    """Identity forward; clips the GRADIENT flowing back through this point
    to [min, max] — the functional form of the reference's per-variable
    ``error_clip`` (``clip.py:41``)."""
    return _ErrorClip.apply(x, max, min)


class ErrorClipByValue(GradientClipByValue):
    """Reference ``clip.py:41``: clip the error (gradient) of a variable to
    [min, max] during backprop. Wrap the tensor inside the model:
    ``x = ErrorClipByValue(max=5.0).apply(x)``; calling it on a gradient
    dict behaves like :class:`GradientClipByValue`."""

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return error_clip_by_value(x, self.max, self.min)

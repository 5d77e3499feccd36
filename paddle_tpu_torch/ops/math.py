"""Math ops — the subset of ``paddle_tpu.ops.math`` the ported slices use.
(The matmul of ``layers.fc`` is :func:`paddle_tpu_torch.core.dtypes.f32_matmul`
on :func:`~paddle_tpu_torch.core.dtypes.mxu_operands`.)"""

from __future__ import annotations

import torch

__all__ = ["relu", "reduce_mean"]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def reduce_mean(x: torch.Tensor, dim=None, keep_dim: bool = False) -> torch.Tensor:
    """Mean over ``dim`` (an int, a list of ints, or None for all)."""
    dims = tuple(range(x.dim())) if dim is None else (
        tuple(dim) if isinstance(dim, (list, tuple)) else dim)
    return torch.mean(x, dim=dims, keepdim=keep_dim)

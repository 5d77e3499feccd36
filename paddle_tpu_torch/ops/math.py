"""Math ops — the subset of ``paddle_tpu.ops.math`` the ported slices use.
(The matmul of ``layers.fc`` is :func:`paddle_tpu_torch.core.dtypes.f32_matmul`
on :func:`~paddle_tpu_torch.core.dtypes.mxu_operands`.)"""

from __future__ import annotations

import torch

__all__ = ["relu", "relu6", "sigmoid", "tanh", "gelu", "leaky_relu", "elu", "swish",
           "reduce_mean"]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 6)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation by default."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x: torch.Tensor, alpha: float = 0.02) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * (torch.exp(x) - 1))


def swish(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    return x * torch.sigmoid(beta * x)


def reduce_mean(x: torch.Tensor, dim=None, keep_dim: bool = False) -> torch.Tensor:
    """Mean over ``dim`` (an int, a list of ints, or None for all)."""
    dims = tuple(range(x.dim())) if dim is None else (
        tuple(dim) if isinstance(dim, (list, tuple)) else dim)
    return torch.mean(x, dim=dims, keepdim=keep_dim)

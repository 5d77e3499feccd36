"""Fake-quantization ops (quantization-aware training) — port of
``paddle_tpu/ops/quant.py``, name for name.

Reference: ``paddle/fluid/operators/fake_quantize_op.cc`` (fake_quantize_
abs_max, fake_channel_wise_quantize_abs_max, fake_quantize_moving_average_
abs_max) and ``fake_dequantize_op.cc``.

Quantize/dequantize stay in float: the point is to simulate INT-k rounding
inside the forward pass. Gradients flow through the round unchanged (the
straight-through estimator, :class:`_SteRound`), as the reference's grad
kernels pass them. As in the JAX package:

- the round is half to even (``torch.round``, as ``jnp.round``);
- the clip to ``±levels`` is ``jnp.clip``'s (:func:`~.math.clip`): the
  element of largest magnitude lands exactly on the bound and takes half
  the gradient there;
- the scale is not detached: the gradient runs through ``max|x|``, and
  maxima that tie share it (``torch.amax``);
- the moving scale is returned, not mutated.

Plain PyTorch: the JAX package leaves these to XLA, so no kernel is owed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops import math as om

__all__ = [
    "fake_quantize_abs_max",
    "fake_channel_wise_quantize_abs_max",
    "fake_quantize_moving_average_abs_max",
    "fake_dequantize_max_abs",
]


class _SteRound(torch.autograd.Function):
    """Round half to even forward; the identity backward."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _quant_levels(bit_length: int) -> float:
    return float((1 << (bit_length - 1)) - 1)


def fake_quantize_abs_max(x: torch.Tensor, bit_length: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor fake quantization: scale = max|x|; returns
    ``(quantized_dequantized, scale)`` (reference fake_quantize_abs_max)."""
    levels = _quant_levels(bit_length)
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's
    scale = torch.amax(om.abs(x)).clamp_min(1e-12)
    q = om.clip(_SteRound.apply(x / scale * levels), -levels, levels)
    return q * scale / levels, scale


def fake_channel_wise_quantize_abs_max(
    x: torch.Tensor, bit_length: int = 8, channel_axis: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric fake quantization (reference
    fake_channel_wise_quantize_abs_max; conv weight layout)."""
    levels = _quant_levels(bit_length)
    channel_axis = channel_axis % x.dim()
    axes = tuple(i for i in range(x.dim()) if i != channel_axis)
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's
    scale = torch.amax(om.abs(x), dim=axes, keepdim=True).clamp_min(1e-12)
    q = om.clip(_SteRound.apply(x / scale * levels), -levels, levels)
    return q * scale / levels, scale.reshape(x.shape[channel_axis])


def fake_quantize_moving_average_abs_max(
    x: torch.Tensor,
    moving_scale: torch.Tensor,
    bit_length: int = 8,
    moving_rate: float = 0.9,
    is_test: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activation quantization with an EMA scale (reference
    fake_quantize_moving_average_abs_max): in training the scale state is
    ``rate*state + (1-rate)*max|x|``, returned beside the output."""
    levels = _quant_levels(bit_length)
    if is_test:
        scale = moving_scale
    else:
        scale = moving_rate * moving_scale + (1.0 - moving_rate) * torch.amax(om.abs(x))
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's
    scale = scale.clamp_min(1e-12)
    q = om.clip(_SteRound.apply(x / scale * levels), -levels, levels)
    return q * scale / levels, scale


def fake_dequantize_max_abs(x: torch.Tensor, scale: torch.Tensor, max_range: float) -> torch.Tensor:
    """Dequantize integers back to float (reference fake_dequantize_max_abs):
    ``out = x * scale / max_range``."""
    return x * scale / max_range

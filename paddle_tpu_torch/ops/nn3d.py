"""3-D conv/pool ops over NDHWC volumes — port of ``paddle_tpu/ops/nn3d.py``.

Reference: ``operators/conv_op.cc`` (conv3d registered alongside conv2d),
``operators/conv_transpose_op.cc`` (conv3d_transpose),
``operators/pool_op.cc`` (pool3d). Volumes are NDHWC and weights DHWIO at
the API, as in the JAX package; each op permutes to PyTorch's NCDHW at its
boundary and runs cuDNN's kernels on the card (the JAX package leaves them
to XLA, so no hand-written kernel is owed). The convolutions take their
operands as given (the JAX package does not cast them to the compute
dtype here), accumulate in f32, and run f32 operands in full f32 on the card
(``ops.nn.convolution``).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.nn import _same_pads, convolution

__all__ = ["conv3d", "conv3d_transpose", "pool3d"]

_IntOrTriple = Union[int, Sequence[int]]


def _triple(v: _IntOrTriple) -> Tuple[int, int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1]), int(v[2])
    return int(v), int(v), int(v)


def _operands(x: torch.Tensor, weight: torch.Tensor):
    dt = torch.promote_types(x.dtype, weight.dtype)
    return x.to(dt).permute(0, 4, 1, 2, 3), weight.to(dt)


def conv3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: _IntOrTriple = 1,
    padding: Union[str, _IntOrTriple] = 0,
    dilation: _IntOrTriple = 1,
    groups: int = 1,
) -> torch.Tensor:
    """3-D convolution, NDHWC activations x DHWIO weights (reference
    ``conv3d`` kernel in ``operators/conv_op.cc``); ``padding`` ints or
    "SAME"/"VALID" as in XLA (SAME puts the odd extra plane on the high
    side)."""
    xn, w = _operands(x, weight)
    wn = w.permute(4, 3, 0, 1, 2)  # [O, I, kd, kh, kw]
    st, dil = _triple(stride), _triple(dilation)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME', 'VALID' or ints, got {padding!r}")
        pads = [(0, 0)] * 3
        if mode == "SAME":
            pads = [_same_pads(x.shape[1 + i], weight.shape[i], st[i], dil[i]) for i in range(3)]
        if any(lo != hi for lo, hi in pads):
            xn = F.pad(xn, [p for lo_hi in reversed(pads) for p in lo_hi])
            pad = (0, 0, 0)
        else:
            pad = tuple(lo for lo, _ in pads)
    else:
        pad = _triple(padding)
    out = convolution(xn, wn, st, pad, dil, groups)
    return out.permute(0, 2, 3, 4, 1).to(x.dtype)


def conv3d_transpose(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: _IntOrTriple = 1,
    padding: _IntOrTriple = 0,
    output_padding: _IntOrTriple = 0,
) -> torch.Tensor:
    """Transposed 3-D conv (reference ``conv_transpose_op.cc`` conv3d path),
    DHWIO weight with I = in_channels of x, O = out_channels: the adjoint of
    a strided convolution, as ``ops.nn.conv2d_transpose``; output size
    (in - 1) * stride - 2 * padding + k + output_padding, with
    ``output_padding`` below the stride."""
    st, op = _triple(stride), _triple(output_padding)
    if any(o >= s for o, s in zip(op, st)):
        raise ValueError(f"conv3d_transpose: output_padding {op} must be below the stride {st}")
    xn, w = _operands(x, weight)
    wn = w.permute(3, 4, 0, 1, 2)  # [I, O, kd, kh, kw]
    out = convolution(xn, wn, st, _triple(padding), None, 1, True, op)
    return out.permute(0, 2, 3, 4, 1).to(x.dtype)


def pool3d(
    x: torch.Tensor,
    pool_size: _IntOrTriple = 2,
    pool_type: str = "max",
    pool_stride: _IntOrTriple = 1,
    pool_padding: _IntOrTriple = 0,
    exclusive: bool = True,
    global_pooling: bool = False,
) -> torch.Tensor:
    """Max/avg pooling over NDHWC (reference ``pool_op.cc`` pool3d kernels,
    incl. ``exclusive`` average counting over non-padding elements): the
    input is padded explicitly (-inf for max, 0 for avg), then pooled with
    no further padding."""
    if global_pooling:
        pool_size = (x.shape[1], x.shape[2], x.shape[3])
        pool_padding = 0
    k, st = _triple(pool_size), _triple(pool_stride)
    pd, ph, pw = _triple(pool_padding)
    pads = (pw, pw, ph, ph, pd, pd)  # F.pad order: W, H, D
    xn = x.permute(0, 4, 1, 2, 3)
    if pool_type == "max":
        padded = F.pad(xn, pads, value=-float("inf")) if any(pads) else xn
        out = F.max_pool3d(padded, k, st)
    elif pool_type == "avg":
        padded = F.pad(xn.float(), pads, value=0.0) if any(pads) else xn.float()
        summed = F.avg_pool3d(padded, k, st, divisor_override=1)
        if exclusive and any(pads):
            ones = F.pad(torch.ones((1, 1) + tuple(x.shape[1:4]), device=x.device), pads)
            out = summed / F.avg_pool3d(ones, k, st, divisor_override=1)
        else:
            out = summed / float(k[0] * k[1] * k[2])
        out = out.to(x.dtype)
    else:
        raise ValueError(f"pool_type must be 'max' or 'avg', got {pool_type!r}")
    return out.permute(0, 2, 3, 4, 1)

"""Composite network helpers — ``fluid.nets`` parity, port of
``paddle_tpu/nets.py``.

Reference: ``python/paddle/fluid/nets.py`` (simple_img_conv_pool:24,
img_conv_group:78, sequence_conv_pool:172, glu:213,
scaled_dot_product_attention:332). Each helper composes layer functions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from paddle_tpu_torch import layers
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import name_scope
from paddle_tpu_torch.ops import attention as oattn

__all__ = [
    "simple_img_conv_pool",
    "img_conv_group",
    "sequence_conv_pool",
    "glu",
    "scaled_dot_product_attention",
]


def simple_img_conv_pool(
    input: torch.Tensor,
    num_filters: int,
    filter_size: Union[int, Sequence[int]],
    pool_size: Union[int, Sequence[int]],
    pool_stride: Union[int, Sequence[int]],
    pool_padding: Union[int, Sequence[int]] = 0,
    pool_type: str = "max",
    conv_stride: Union[int, Sequence[int]] = 1,
    conv_padding: Union[int, Sequence[int], str] = "SAME",
    conv_dilation: Union[int, Sequence[int]] = 1,
    conv_groups: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    use_cudnn: bool = True,  # accepted for config parity
    data_format: str = "NHWC",
    name: Optional[str] = None,
) -> torch.Tensor:
    """Conv2d followed by pool2d (reference ``nets.py:24``)."""
    with name_scope(name or "conv_pool"):
        conv_out = layers.conv2d(
            input,
            num_filters=num_filters,
            filter_size=filter_size,
            stride=conv_stride,
            padding=conv_padding,
            dilation=conv_dilation,
            groups=conv_groups,
            param_attr=param_attr,
            bias_attr=bias_attr,
            act=act,
            data_format=data_format,
        )
        return layers.pool2d(
            conv_out,
            pool_size=pool_size,
            pool_type=pool_type,
            pool_stride=pool_stride,
            pool_padding=pool_padding,
            data_format=data_format,
        )


def img_conv_group(
    input: torch.Tensor,
    conv_num_filter: Sequence[int],
    pool_size: Union[int, Sequence[int]],
    conv_padding: Union[int, Sequence[int], str] = "SAME",
    conv_filter_size: Union[int, Sequence[int]] = 3,
    conv_act: Optional[str] = None,
    param_attr=None,
    conv_with_batchnorm: Union[bool, Sequence[bool]] = False,
    conv_batchnorm_drop_rate: Union[float, Sequence[float]] = 0.0,
    pool_stride: Union[int, Sequence[int]] = 1,
    pool_type: str = "max",
    data_format: str = "NHWC",
    name: Optional[str] = None,
) -> torch.Tensor:
    """Stack of conv(+BN+dropout) layers followed by one pool (reference
    ``nets.py:78``, the VGG building block)."""
    n = len(conv_num_filter)

    def _expand(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * n

    with_bn = _expand(conv_with_batchnorm)
    drop_rate = _expand(conv_batchnorm_drop_rate)
    enforce(len(with_bn) == n and len(drop_rate) == n, "per-conv arg length mismatch")

    with name_scope(name or "conv_group"):
        tmp = input
        for i in range(n):
            tmp = layers.conv2d(
                tmp,
                num_filters=conv_num_filter[i],
                filter_size=conv_filter_size,
                padding=conv_padding,
                param_attr=param_attr,
                act=None if with_bn[i] else conv_act,
                data_format=data_format,
            )
            if with_bn[i]:
                tmp = layers.batch_norm(tmp, act=conv_act, data_format=data_format)
                if drop_rate[i] > 0:
                    tmp = layers.dropout(tmp, dropout_prob=drop_rate[i])
        return layers.pool2d(
            tmp,
            pool_size=pool_size,
            pool_type=pool_type,
            pool_stride=pool_stride,
            data_format=data_format,
        )


def sequence_conv_pool(
    input: torch.Tensor,
    lengths: torch.Tensor,
    num_filters: int,
    filter_size: int,
    param_attr=None,
    act: str = "sigmoid",
    pool_type: str = "max",
    name: Optional[str] = None,
) -> torch.Tensor:
    """sequence_conv + sequence_pool over padded [B, T, D] + lengths
    (reference ``nets.py:172``; text-conv models)."""
    with name_scope(name or "seq_conv_pool"):
        conv_out = layers.sequence_conv(
            input, lengths, num_filters=num_filters, filter_size=filter_size,
            param_attr=param_attr, act=act,
        )
        return layers.sequence_pool(conv_out, lengths, pool_type=pool_type)


def glu(input: torch.Tensor, dim: int = -1, name: Optional[str] = None) -> torch.Tensor:
    """Gated linear unit: split in half along dim, a * sigmoid(b)
    (reference ``nets.py:213``)."""
    a, b = torch.chunk(input, 2, dim=dim)
    return a * torch.sigmoid(b)


def scaled_dot_product_attention(
    queries: torch.Tensor,
    keys: torch.Tensor,
    values: torch.Tensor,
    num_heads: int = 1,
    dropout_rate: float = 0.0,
    mask: Optional[torch.Tensor] = None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """Multi-head scaled dot-product attention over [B, T, D] inputs
    (reference ``nets.py:332``). Projection-free like the reference: heads
    are formed by splitting the feature axis, and
    ``ops.attention.scaled_dot_product_attention`` attends over them. With
    ``flags().use_flash_attention`` on, no mask and no dropout in effect,
    and sequence lengths the block tiling divides, that is the hand-written
    flash forward (and, under autograd, its dK/dV and dQ kernels). Dropout
    acts only in a training-mode apply and draws from its generator
    (``framework.next_rng``)."""
    from paddle_tpu_torch import framework

    q = oattn.split_heads(queries, num_heads)
    k = oattn.split_heads(keys, num_heads)
    v = oattn.split_heads(values, num_heads)
    training = framework.in_frame() and framework.is_training()
    out = oattn.scaled_dot_product_attention(
        q, k, v, mask=mask, dropout_rate=dropout_rate, is_test=not training)
    return oattn.combine_heads(out)

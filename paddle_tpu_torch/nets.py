"""Composite network helpers — the part of ``paddle_tpu.nets`` (``fluid.nets``
parity, reference ``python/paddle/fluid/nets.py``) the ported slices use."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from paddle_tpu_torch import layers
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import name_scope

__all__ = ["simple_img_conv_pool", "img_conv_group"]


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

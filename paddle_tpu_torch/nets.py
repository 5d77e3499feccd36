"""Composite network helpers — the part of ``paddle_tpu.nets`` (``fluid.nets``
parity, reference ``python/paddle/fluid/nets.py``) the ported slices use."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from paddle_tpu_torch import layers
from paddle_tpu_torch.framework import name_scope

__all__ = ["simple_img_conv_pool"]


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

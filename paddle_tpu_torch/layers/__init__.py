"""Declarative layer API — the subset of ``paddle_tpu.layers`` the ported
slices use: ``fc``, ``embedding``, ``conv2d``, ``pool2d``,
``batch_norm``, ``layer_norm``, ``dropout``, ``dynamic_lstm``, the
activations, and the functional ops re-exported under ``layers.*``
(``softmax_with_cross_entropy``, ``reduce_mean``, ``accuracy``,
``one_hot``, ``label_smooth``, the sequence ops, ...).

Each layer function creates/fetches its named parameters through
:mod:`paddle_tpu_torch.framework` (the JAX package's names) and returns the
computed tensor. Images are NHWC; ``data_format="NCHW"`` inputs are
transposed on entry, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from paddle_tpu_torch import framework, initializer as init_mod
from paddle_tpu_torch.core.dtypes import f32_matmul, mxu_operands
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import create_parameter, create_state, name_scope, update_state
from paddle_tpu_torch.ops import math as om
from paddle_tpu_torch.ops import nn as on
from paddle_tpu_torch.ops import rnn as orn
from paddle_tpu_torch.ops.math import (  # noqa: F401
    elu,
    gelu,
    leaky_relu,
    reduce_mean,
    relu,
    relu6,
    sigmoid,
    swish,
    tanh,
)
# functional ops re-exported under layers.* for fluid.layers parity
from paddle_tpu_torch.ops.nn import (  # noqa: F401
    accuracy,
    cross_entropy,
    label_smooth,
    one_hot,
    softmax,
    softmax_with_cross_entropy,
    square_error_cost,
)
from paddle_tpu_torch.ops.sequence import (  # noqa: F401
    sequence_concat,
    sequence_enumerate,
    sequence_expand,
    sequence_expand_as,
    sequence_first_step,
    sequence_last_step,
    sequence_mask,
    sequence_pad,
    sequence_pool,
    sequence_reshape,
    sequence_reverse,
    sequence_scatter,
    sequence_slice,
    sequence_softmax,
)

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "dropout", "dynamic_lstm",
    "relu", "relu6", "sigmoid", "tanh", "gelu", "leaky_relu", "swish", "elu",
    "reduce_mean", "accuracy", "cross_entropy", "softmax", "softmax_with_cross_entropy",
    "square_error_cost", "one_hot", "label_smooth",
    "sequence_pool", "sequence_softmax", "sequence_reverse", "sequence_first_step",
    "sequence_last_step", "sequence_expand", "sequence_pad", "sequence_concat",
    "sequence_enumerate", "sequence_expand_as", "sequence_mask", "sequence_reshape",
    "sequence_scatter", "sequence_slice",
]

_ACTS = {
    None: lambda x: x,
    "relu": om.relu,
    "relu6": om.relu6,
    "sigmoid": om.sigmoid,
    "tanh": om.tanh,
    "softmax": on.softmax,
    "gelu": om.gelu,
    "leaky_relu": om.leaky_relu,
    "swish": om.swish,
    "elu": om.elu,
}


def _act(x, act: Optional[str]):
    if act not in _ACTS:
        raise KeyError(f"unknown activation {act!r}; known: {sorted(k for k in _ACTS if k)}")
    return _ACTS[act](x)


def _to_nhwc(x, data_format: str):
    return x.permute(0, 2, 3, 1) if data_format == "NCHW" else x


def _from_nhwc(x, data_format: str):
    return x.permute(0, 3, 1, 2) if data_format == "NCHW" else x


def fc(
    input: torch.Tensor,
    size: int,
    num_flatten_dims: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """Fully-connected layer (reference ``layers/nn.py`` fc → mul+sum ops).
    Flattens trailing dims from ``num_flatten_dims`` into the matmul axis.
    Operands in the compute dtype, f32 accumulation, result in the input's
    dtype.

    Tensor parallelism (Megatron's layout, where the run holds the weight
    as a block split over the mesh axis its ``param_attr`` sharding names,
    :func:`framework.split_axis`): a weight split on its output dim
    (column-parallel, ``(None, "model")``) takes the whole input through
    ``copy_to_axis`` and gives this rank's columns, the bias sliced alike;
    a weight split on its input dim (row-parallel, ``("model", None)``)
    takes this rank's columns of the input and sums the ranks' partial
    products (``reduce_from_axis``), adding the bias once, after the sum. A
    weight held whole (a dim the axis does not divide) is the plain layer."""
    from paddle_tpu_torch.framework import ParamAttr, split_axis
    from paddle_tpu_torch.parallel import collective

    with name_scope(name or "fc"):
        lead = input.shape[:num_flatten_dims]
        in_dim = 1
        for s in input.shape[num_flatten_dims:]:
            in_dim *= s
        x2 = input.reshape(-1, in_dim)
        w_name = ParamAttr.to_attr(param_attr).name or "w"
        col, row = split_axis(w_name, 1), split_axis(w_name, 0)
        w = create_parameter([in_dim * (collective.axis_size(row) if row else 1), size],
                             input.dtype, name="w", attr=param_attr)
        enforce(w.shape[0] == in_dim, f"fc {name!r}: the input's {in_dim} features do not match "
                f"the weight's block {tuple(w.shape)}")
        if col:
            x2 = collective.copy_to_axis(x2, col)
        out = f32_matmul(*mxu_operands(x2, w)).to(input.dtype)
        if row:
            out = collective.reduce_from_axis(out, row)
        if bias_attr is not False:
            b = create_parameter(
                [size], input.dtype, name="b", attr=bias_attr, default_initializer=init_mod.Constant(0.0)
            )
            out = out + (collective.shard_replicated(b, col, 0) if col else b)
        out = out.reshape(tuple(lead) + (out.shape[-1],))
        return _act(out, act)


def embedding(
    input: torch.Tensor,
    size: Sequence[int],
    param_attr=None,
    padding_idx: Optional[int] = None,
    dtype="float32",
    name: Optional[str] = None,
) -> torch.Tensor:
    """Embedding lookup (reference ``lookup_table_op``). A table split over
    its columns (``(None, "model")``, where the run holds the table as a
    block split over that axis) looks up this rank's columns and gathers
    the ranks' (whose backward keeps this rank's slice of the gradient)."""
    from paddle_tpu_torch.framework import ParamAttr, split_axis
    from paddle_tpu_torch.parallel import collective

    with name_scope(name or "embedding"):
        col = split_axis(ParamAttr.to_attr(param_attr).name or "w", 1)
        table = create_parameter(
            list(size), dtype, name="w", attr=param_attr, default_initializer=init_mod.Xavier()
        )
        out = on.embedding_lookup(table, input, padding_idx=padding_idx)
        if col:
            out = collective.gather_replicated(out, col, -1)
        return out


def conv2d(
    input: torch.Tensor,
    num_filters: int,
    filter_size: Union[int, Sequence[int]],
    stride: Union[int, Sequence[int]] = 1,
    padding: Union[int, Sequence[int], str] = 0,
    dilation: Union[int, Sequence[int]] = 1,
    groups: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    data_format: str = "NHWC",
    name: Optional[str] = None,
) -> torch.Tensor:
    """2-D convolution layer: ``w`` [kh, kw, Cin/groups, num_filters] (HWIO,
    He-normal init) and ``b`` [num_filters]."""
    with name_scope(name or "conv2d"):
        x = _to_nhwc(input, data_format)
        kh, kw = (filter_size, filter_size) if isinstance(filter_size, int) else tuple(filter_size)
        cin = x.shape[-1]
        enforce(cin % groups == 0, f"channels {cin} not divisible by groups {groups}")
        w = create_parameter(
            [kh, kw, cin // groups, num_filters], x.dtype, name="w", attr=param_attr,
            default_initializer=init_mod.MSRA(uniform=False),
        )
        out = on.conv2d(x, w, stride=stride, padding=padding, dilation=dilation, groups=groups)
        if bias_attr is not False:
            b = create_parameter(
                [num_filters], x.dtype, name="b", attr=bias_attr,
                default_initializer=init_mod.Constant(0.0),
            )
            out = out + b
        return _from_nhwc(_act(out, act), data_format)


def pool2d(
    input: torch.Tensor,
    pool_size: Union[int, Sequence[int]] = 2,
    pool_type: str = "max",
    pool_stride: Union[int, Sequence[int]] = 1,
    pool_padding: Union[int, Sequence[int]] = 0,
    global_pooling: bool = False,
    ceil_mode: bool = False,
    exclusive: bool = True,
    data_format: str = "NHWC",
) -> torch.Tensor:
    out = on.pool2d(
        _to_nhwc(input, data_format), pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding, ceil_mode=ceil_mode,
        exclusive=exclusive, global_pooling=global_pooling,
    )
    return _from_nhwc(out, data_format)


def batch_norm(
    input: torch.Tensor,
    act: Optional[str] = None,
    momentum: float = 0.9,
    epsilon: float = 1e-5,
    param_attr=None,
    bias_attr=None,
    is_test: Optional[bool] = None,
    data_format: str = "NHWC",
    name: Optional[str] = None,
) -> torch.Tensor:
    """BatchNorm (reference ``operators/batch_norm_op.cc``): ``scale`` and
    ``bias`` parameters, ``moving_mean`` and ``moving_variance`` in the
    state collection (fluid kept them as persistable variables updated in
    place; here they thread through ``apply``'s new state). Training mode
    normalizes with the batch statistics and records the moving averages;
    eval mode (``is_test``, or an apply that is not training) reads them."""
    with name_scope(name or "batch_norm"):
        x = _to_nhwc(input, data_format)
        c = x.shape[-1]
        scale = create_parameter([c], "float32", name="scale", attr=param_attr,
                                 default_initializer=init_mod.Constant(1.0))
        bias = create_parameter([c], "float32", name="bias", attr=bias_attr,
                                default_initializer=init_mod.Constant(0.0))
        mean = create_state("moving_mean", [c], "float32", init=lambda s, d: torch.zeros(s, dtype=d))
        var = create_state("moving_variance", [c], "float32", init=lambda s, d: torch.ones(s, dtype=d))
        training = framework.is_training() if is_test is None else (not is_test)
        if training:
            y, new_mean, new_var, _, _ = on.batch_norm_train(x, scale, bias, mean, var, momentum, epsilon)
            update_state("moving_mean", new_mean)
            update_state("moving_variance", new_var)
        else:
            y = on.batch_norm_infer(x, scale, bias, mean, var, epsilon)
        return _from_nhwc(_act(y, act), data_format)


def layer_norm(
    input: torch.Tensor,
    scale: bool = True,
    shift: bool = True,
    begin_norm_axis: int = 1,
    epsilon: float = 1e-5,
    param_attr=None,
    bias_attr=None,
    name: Optional[str] = None,
) -> torch.Tensor:
    with name_scope(name or "layer_norm"):
        norm_shape = input.shape[begin_norm_axis:]
        dim = 1
        for s in norm_shape:
            dim *= s
        g = (
            create_parameter([dim], "float32", name="scale", attr=param_attr,
                             default_initializer=init_mod.Constant(1.0))
            if scale
            else None
        )
        b = (
            create_parameter([dim], "float32", name="bias", attr=bias_attr,
                             default_initializer=init_mod.Constant(0.0))
            if shift
            else None
        )
        flat = input.reshape(tuple(input.shape[:begin_norm_axis]) + (dim,))
        out = on.layer_norm(flat, g, b, begin_norm_axis=-1, epsilon=epsilon)
        return out.reshape(input.shape)


def dropout(x: torch.Tensor, dropout_prob: float, is_test: Optional[bool] = None, name=None,
            block=None) -> torch.Tensor:
    """Dropout with the reference's 'upscale_in_train' implementation; in a
    training-mode apply the mask comes from the apply's ``rng``. ``block``:
    ``x`` is a rank's block of a split tensor (``ops.nn.dropout``)."""
    training = framework.is_training() if is_test is None else (not is_test)
    return on.dropout(x, dropout_prob, is_test=not training, block=block)


def dynamic_lstm(
    input: torch.Tensor,
    size: int,
    lengths: Optional[torch.Tensor] = None,
    param_attr=None,
    bias_attr=None,
    is_reverse: bool = False,
    proj_input: bool = True,
    name: Optional[str] = None,
):
    """LSTM over padded [B, T, D] (reference ``dynamic_lstm`` layer; here
    ``size`` is the hidden size H, weights [D,4H]/[H,4H]). Returns
    (hidden [B,T,H], (h_final, c_final)).

    ``proj_input=False`` reproduces fluid semantics exactly: the input must
    already be fc-projected to [B, T, 4H] and no w_ih is created (reference
    dynamic_lstm has only recurrent weights — the preceding fc IS the input
    projection)."""
    with name_scope(name or "lstm"):
        d = input.shape[-1]
        if proj_input:
            w_ih = create_parameter([d, 4 * size], input.dtype, name="w_ih", attr=param_attr)
        else:
            enforce(d == 4 * size, f"proj_input=False expects input dim {4*size}, got {d}")
            w_ih = None
        w_hh = create_parameter([size, 4 * size], input.dtype, name="w_hh", attr=param_attr)
        b = (
            create_parameter([4 * size], input.dtype, name="b", attr=bias_attr,
                             default_initializer=init_mod.Constant(0.0))
            if bias_attr is not False
            else None
        )
        return orn.dynamic_lstm(input, w_ih, w_hh, b, lengths=lengths, reverse=is_reverse)


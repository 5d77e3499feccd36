"""Declarative layer API — the ``fluid.layers`` equivalent, port of
``paddle_tpu/layers/__init__.py``: the layer functions (``fc``,
``embedding``, ``conv2d``, ``conv2d_transpose``, ``pool2d``,
``batch_norm``, ``layer_norm``, ``dropout``, ``prelu``, ``dynamic_lstm``,
``dynamic_gru``, ``sequence_conv``, ``data``), the extended catalog
(:mod:`.extended`), the reader layers (:mod:`.io_layers`), and the
functional ops re-exported under their fluid names (all of ``ops.math``,
the ``ops.nn``/``ops.sequence``/``ops.control_flow``/``ops.losses`` names,
the ``ops.detection``/``ops.detection_rpn`` names, the learning-rate
schedules) and the SSD head :func:`multi_box_head`. ``__all__`` is the JAX
package's.

Each layer function creates/fetches its named parameters through
:mod:`paddle_tpu_torch.framework` (the JAX package's names) and returns the
computed tensor. Images are NHWC; ``data_format="NCHW"`` inputs are
transposed on entry, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from paddle_tpu_torch import framework, initializer as init_mod
from paddle_tpu_torch.core.dtypes import f32_matmul, mxu_operands
from paddle_tpu_torch.core.enforce import enforce, enforce_in
from paddle_tpu_torch.framework import create_parameter, create_state, name_scope, update_state
from paddle_tpu_torch.ops import math as om
from paddle_tpu_torch.ops import nn as on
from paddle_tpu_torch.ops import rnn as orn
from paddle_tpu_torch.ops import sequence as oseq

# functional ops re-exported under layers.* for fluid.layers parity
from paddle_tpu_torch.ops.math import *  # noqa: F401,F403
from paddle_tpu_torch.ops.nn import (  # noqa: F401
    softmax,
    log_softmax,
    cross_entropy,
    softmax_with_cross_entropy,
    sigmoid_cross_entropy_with_logits,
    square_error_cost,
    smooth_l1,
    huber_loss,
    kldiv_loss,
    log_loss,
    accuracy,
    one_hot,
    label_smooth,
    l2_normalize,
    cos_sim,
    lrn,
    pad2d,
    resize_bilinear,
    resize_nearest,
    pixel_shuffle,
)
from paddle_tpu_torch.ops.sequence import (  # noqa: F401
    sequence_pool,
    sequence_softmax,
    sequence_reverse,
    sequence_first_step,
    sequence_last_step,
    sequence_expand,
)

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


def conv2d_transpose(
    input: torch.Tensor,
    num_filters: int,
    filter_size: Union[int, Sequence[int]],
    stride: Union[int, Sequence[int]] = 1,
    padding: Union[int, Sequence[int]] = 0,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    data_format: str = "NHWC",
    name: Optional[str] = None,
) -> torch.Tensor:
    """Transposed 2-D convolution layer: ``w`` [kh, kw, Cin, num_filters]
    (HWIO, Xavier init) and ``b`` [num_filters]."""
    with name_scope(name or "conv2d_transpose"):
        x = _to_nhwc(input, data_format)
        kh, kw = (filter_size, filter_size) if isinstance(filter_size, int) else tuple(filter_size)
        w = create_parameter([kh, kw, x.shape[-1], num_filters], x.dtype, name="w",
                             attr=param_attr, default_initializer=init_mod.Xavier())
        out = on.conv2d_transpose(x, w, stride=stride, padding=padding)
        if bias_attr is not False:
            b = create_parameter([num_filters], x.dtype, name="b", attr=bias_attr,
                                 default_initializer=init_mod.Constant(0.0))
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



def prelu(x: torch.Tensor, mode: str = "all", param_attr=None, name=None) -> torch.Tensor:
    """PReLU with a learned slope ``alpha`` (init 0.25): one for ``all``,
    one per channel (last axis) for ``channel``, one per element of a row
    for ``element``."""
    with name_scope(name or "prelu"):
        enforce_in(mode, ["all", "channel", "element"], "prelu mode")
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [x.shape[-1]]
        else:
            shape = list(x.shape[1:])
        alpha = create_parameter(shape, x.dtype, name="alpha", attr=param_attr,
                                 default_initializer=init_mod.Constant(0.25))
        return on.prelu(x, alpha)


def dynamic_gru(
    input: torch.Tensor,
    size: int,
    lengths: Optional[torch.Tensor] = None,
    param_attr=None,
    bias_attr=None,
    is_reverse: bool = False,
    proj_input: bool = True,
    name: Optional[str] = None,
):
    """GRU over padded [B, T, D] (reference ``dynamic_gru`` layer; ``size``
    is the hidden size H, weights ``w_ih`` [D, 3H] / ``w_hh`` [H, 3H], bias
    ``b`` [3H]). Returns (hidden [B, T, H], h_final). ``proj_input=False``:
    the input is already projected to [B, T, 3H] and no ``w_ih`` is made."""
    with name_scope(name or "gru"):
        d = input.shape[-1]
        if proj_input:
            w_ih = create_parameter([d, 3 * size], input.dtype, name="w_ih", attr=param_attr)
        else:
            enforce(d == 3 * size, f"proj_input=False expects input dim {3*size}, got {d}")
            w_ih = None
        w_hh = create_parameter([size, 3 * size], input.dtype, name="w_hh", attr=param_attr)
        b = (
            create_parameter([3 * size], input.dtype, name="b", attr=bias_attr,
                             default_initializer=init_mod.Constant(0.0))
            if bias_attr is not False
            else None
        )
        return orn.dynamic_gru(input, w_ih, w_hh, b, lengths=lengths, reverse=is_reverse)


def sequence_conv(
    input: torch.Tensor,
    lengths: torch.Tensor,
    num_filters: int,
    filter_size: int = 3,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """Context-window convolution over padded [B, T, D] + lengths
    (reference ``sequence_conv_op``): ``w`` [filter_size * D, num_filters]
    and ``b``."""
    with name_scope(name or "sequence_conv"):
        d = input.shape[-1]
        w = create_parameter([filter_size * d, num_filters], input.dtype, name="w", attr=param_attr)
        out = oseq.sequence_conv(input, lengths, w, filter_size)
        if bias_attr is not False:
            b = create_parameter([num_filters], input.dtype, name="b", attr=bias_attr,
                                 default_initializer=init_mod.Constant(0.0))
            out = out + b
        return _act(out, act)


def multi_box_head(
    inputs: Sequence[torch.Tensor],
    image_shape: Tuple[int, int],
    num_classes: int,
    min_sizes: Sequence[float],
    max_sizes: Sequence[float] = (),
    aspect_ratios: Optional[Sequence[Sequence[float]]] = None,
    flip: bool = True,
    clip: bool = False,
    name: Optional[str] = None,
):
    """SSD MultiBox head (reference fluid ``layers.detection.multi_box_head``):
    for each NHWC feature map a 3x3 conv predicts per-prior location offsets
    (``multi_box_head/loc_i``) and class scores (``multi_box_head/conf_i``),
    and prior_box emits the matching priors on the map's device. Returns
    (mbox_locs [B, P, 4], mbox_confs [B, P, C], boxes [P, 4], variances
    [P, 4]) with P the priors of all maps."""
    from paddle_tpu_torch.ops import detection as odet

    aspect_ratios = aspect_ratios or [[2.0]] * len(inputs)
    locs, confs, boxes_all, vars_all = [], [], [], []
    with name_scope(name or "multi_box_head"):
        for i, feat in enumerate(inputs):
            h, w = feat.shape[1], feat.shape[2]
            boxes, variances = odet.prior_box(
                (h, w), image_shape, [min_sizes[i]],
                [max_sizes[i]] if i < len(max_sizes) else (),
                aspect_ratios[i], flip=flip, clip=clip, device=feat.device,
            )
            p = boxes.shape[2]  # priors per cell
            loc = conv2d(feat, p * 4, 3, padding=1, name=f"loc_{i}")
            conf = conv2d(feat, p * num_classes, 3, padding=1, name=f"conf_{i}")
            b = feat.shape[0]
            locs.append(loc.reshape(b, h * w * p, 4))
            confs.append(conf.reshape(b, h * w * p, num_classes))
            boxes_all.append(boxes.reshape(-1, 4))
            vars_all.append(variances.reshape(-1, 4))
    return (torch.cat(locs, dim=1), torch.cat(confs, dim=1), torch.cat(boxes_all),
            torch.cat(vars_all))


class DataSpec(NamedTuple):
    """What :func:`data` declares: an input's shape and torch dtype."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def data(name: str, shape: Sequence[int], dtype="float32", lod_level: int = 0) -> DataSpec:
    """Compatibility declaration: inputs are the program function's
    arguments, so this makes no tensor; it returns the shape and torch dtype
    (the JAX package returns a ``jax.ShapeDtypeStruct``), usable for
    documentation and feeding order."""
    from paddle_tpu_torch.core.dtypes import convert

    return DataSpec(tuple(shape), convert(dtype))


# ---------------------------------------------------------------------------
# Extended catalog: the tail of the fluid layers surface (reference
# layers/nn.py:30 export list + tensor.py/control_flow.py/metric_op.py/io.py)
# ---------------------------------------------------------------------------

# param-creating wrappers, tensor helpers, control-flow adapters, metric ops
from paddle_tpu_torch.layers.extended import *  # noqa: F401,F403,E402
from paddle_tpu_torch.layers.extended import __all__ as _ext_all  # noqa: E402

# reader-pipeline layer API (py_reader / double_buffer / open_files / ...)
from paddle_tpu_torch.layers.io_layers import *  # noqa: F401,F403,E402
from paddle_tpu_torch.layers.io_layers import __all__ as _io_all  # noqa: E402

# functional op re-exports under their fluid names
from paddle_tpu_torch.ops.nn import (  # noqa: F401,E402
    maxout,
    multiplex,
    pad_constant_like,
    rank_loss,
    dice_loss,
    mean_iou,
)
from paddle_tpu_torch.ops.sequence import (  # noqa: F401,E402
    sequence_pad,
    sequence_concat,
    sequence_enumerate,
    sequence_expand_as,
    sequence_mask,
    sequence_reshape,
    sequence_scatter,
    sequence_slice,
    lod_reset,
    reorder_by_rank as reorder_lod_tensor_by_rank,
)
from paddle_tpu_torch.ops.control_flow import (  # noqa: F401,E402
    while_loop,
    cond,
    switch_case,
    case,
    TensorArray,
    create_array,
    array_write,
    array_read,
    array_length,
    static_rnn,
    dynamic_rnn,
    rank_by_length as lod_rank_table,
    beam_search,
    beam_search_decode,
    greedy_search,
)
from paddle_tpu_torch.ops.losses import (  # noqa: F401,E402
    linear_chain_crf,
    crf_decoding,
    edit_distance,
    ctc_loss as warpctc,
    ctc_greedy_decode as ctc_greedy_decoder,
)
from paddle_tpu_torch.ops.detection import (  # noqa: F401,E402
    prior_box,
    anchor_generator,
    bipartite_match,
    target_assign,
    box_coder,
    iou_similarity,
    multiclass_nms,
    detection_output,
    ssd_loss,
    detection_map,
)
from paddle_tpu_torch.ops.detection_rpn import (  # noqa: F401,E402
    rpn_target_assign,
    generate_proposals,
    generate_proposal_labels,
    roi_perspective_transform,
    polygon_box_transform,
)
from paddle_tpu_torch.lr_scheduler import (  # noqa: F401,E402
    exponential_decay,
    natural_exp_decay,
    inverse_time_decay,
    polynomial_decay,
    piecewise_decay,
    noam_decay,
    cosine_decay,
    append_LARS,
)

# the export surface, in the JAX package's order: layer functions defined
# here + the functional ops re-exported above
_LOCAL_LAYERS = [
    "fc", "embedding", "conv2d", "conv2d_transpose", "pool2d", "batch_norm",
    "layer_norm", "dropout", "prelu", "dynamic_lstm", "dynamic_gru",
    "sequence_conv", "data",
]
_OP_REEXPORTS = [
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "square_error_cost", "smooth_l1",
    "huber_loss", "kldiv_loss", "log_loss", "accuracy", "one_hot",
    "label_smooth", "l2_normalize", "cos_sim", "lrn", "pad2d",
    "resize_bilinear", "resize_nearest", "pixel_shuffle",
    "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_first_step", "sequence_last_step", "sequence_expand",
    # extended functional re-exports
    "multiplex", "pad_constant_like", "rank_loss", "dice_loss", "mean_iou",
    "sequence_pad", "sequence_concat", "sequence_enumerate", "sequence_expand_as",
    "sequence_mask", "sequence_reshape", "sequence_scatter", "sequence_slice",
    "lod_reset", "reorder_lod_tensor_by_rank",
    "while_loop", "cond", "switch_case", "case", "TensorArray", "create_array",
    "array_write", "array_read", "array_length", "static_rnn", "dynamic_rnn",
    "lod_rank_table", "beam_search", "beam_search_decode", "greedy_search",
    "linear_chain_crf", "crf_decoding", "edit_distance", "warpctc",
    "ctc_greedy_decoder",
    "prior_box", "anchor_generator", "bipartite_match", "target_assign",
    "box_coder", "iou_similarity", "multiclass_nms",
    "detection_output", "ssd_loss", "detection_map",
    "rpn_target_assign", "generate_proposals", "generate_proposal_labels",
    "roi_perspective_transform", "polygon_box_transform", "multi_box_head",
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "noam_decay", "cosine_decay",
    "append_LARS",
]
__all__ = _LOCAL_LAYERS + _OP_REEXPORTS + list(om.__all__) + list(_ext_all) + list(_io_all)

"""Extended layer catalog — the tail of the fluid ``layers`` surface, port of
``paddle_tpu/layers/extended.py``.

Parameter-creating wrappers (conv3d family, NCE, hsigmoid, row_conv, RNN
units, LSTMP), tensor helpers (assign/sums/fill_constant_batch_size_like...),
block-style control-flow adapters (While/Switch/IfElse/StaticRNN/DynamicRNN),
and metric ops (auc, chunk_eval). The parameter names, shapes and
initializers are the JAX package's, so ``convert.params_from_jax`` carries
every layer's weights across.

Reference: ``python/paddle/fluid/layers/nn.py:30`` export list,
``layers/tensor.py``, ``layers/control_flow.py``, ``layers/metric_op.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch.core import dtypes as dmod
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import create_parameter, create_state, name_scope, update_state
from paddle_tpu_torch.ops import control_flow as ocf
from paddle_tpu_torch.ops import math as om
from paddle_tpu_torch.ops import nn as on
from paddle_tpu_torch.ops import nn3d as o3d
from paddle_tpu_torch.ops import rnn as orn
from paddle_tpu_torch.ops import sequence as oseq
from paddle_tpu_torch.ops import vision as ovis

__all__ = [
    # param-creating layers
    "conv3d",
    "conv3d_transpose",
    "pool3d",
    "nce",
    "hsigmoid",
    "row_conv",
    "gru_unit",
    "lstm_unit",
    "dynamic_lstmp",
    # vision
    "image_resize",
    "image_resize_short",
    "random_crop",
    "roi_pool",
    "im2sequence",
    # tensor helpers
    "assign",
    "create_tensor",
    "create_global_var",
    "fill_constant_batch_size_like",
    "sums",
    "is_empty",
    "autoincreased_step_counter",
    "Print",
    # control-flow adapters
    "While",
    "Switch",
    "IfElse",
    "StaticRNN",
    "DynamicRNN",
    # metrics
    "auc",
    "chunk_eval",
]


def _act(x, act: Optional[str]):
    return x if act is None else getattr(om, act)(x)


def _bias(size: int, dtype, bias_attr):
    if bias_attr is False:
        return None
    return create_parameter([size], dtype, name="b", attr=bias_attr,
                            default_initializer=init_mod.Constant(0.0))


# ---------------------------------------------------------------------------
# 3-D conv family
# ---------------------------------------------------------------------------


def conv3d(
    input: torch.Tensor,
    num_filters: int,
    filter_size: Union[int, Sequence[int]],
    stride: Union[int, Sequence[int]] = 1,
    padding: Union[int, Sequence[int]] = 0,
    dilation: Union[int, Sequence[int]] = 1,
    groups: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """fluid ``layers.conv3d`` over NDHWC input: ``w`` [fd, fh, fw,
    Cin/groups, num_filters] (MSRA init) and ``b``."""
    fd, fh, fw = o3d._triple(filter_size)
    in_c = input.shape[-1]
    with name_scope(name or "conv3d"):
        w = create_parameter([fd, fh, fw, in_c // groups, num_filters], input.dtype, name="w",
                             attr=param_attr, default_initializer=init_mod.MSRA())
        out = o3d.conv3d(input, w, stride, padding, dilation, groups)
        b = _bias(num_filters, input.dtype, bias_attr)
        return _act(out if b is None else out + b, act)


def conv3d_transpose(
    input: torch.Tensor,
    num_filters: int,
    filter_size: Union[int, Sequence[int]],
    stride: Union[int, Sequence[int]] = 1,
    padding: Union[int, Sequence[int]] = 0,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """fluid ``layers.conv3d_transpose``: ``w`` [fd, fh, fw, Cin,
    num_filters] (MSRA init) and ``b``."""
    fd, fh, fw = o3d._triple(filter_size)
    in_c = input.shape[-1]
    with name_scope(name or "conv3d_transpose"):
        w = create_parameter([fd, fh, fw, in_c, num_filters], input.dtype, name="w",
                             attr=param_attr, default_initializer=init_mod.MSRA())
        out = o3d.conv3d_transpose(input, w, stride, padding)
        b = _bias(num_filters, input.dtype, bias_attr)
        return _act(out if b is None else out + b, act)


pool3d = o3d.pool3d

# vision re-exports (no parameters)
image_resize = ovis.image_resize
image_resize_short = ovis.image_resize_short
random_crop = ovis.random_crop
roi_pool = ovis.roi_pool
im2sequence = ovis.im2sequence


# ---------------------------------------------------------------------------
# Sampled / hierarchical losses
# ---------------------------------------------------------------------------


def nce(
    input: torch.Tensor,
    label: torch.Tensor,
    num_total_classes: int,
    num_neg_samples: int = 10,
    rng: Optional[torch.Generator] = None,
    param_attr=None,
    bias_attr=None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """fluid ``layers.nce`` (reference ``nce_op.cc``): creates the
    [num_classes, D] class matrix ``w`` (Xavier) and ``b``, and returns the
    per-row NCE loss. The noise classes come from ``rng`` (a
    ``torch.Generator``), by default one seeded with 0 on the input's device
    (the JAX package's default is the fixed key 0 too)."""
    if rng is None:
        rng = torch.Generator(device=input.device).manual_seed(0)
    d = input.shape[-1]
    with name_scope(name or "nce"):
        w = create_parameter([num_total_classes, d], input.dtype, name="w", attr=param_attr,
                             default_initializer=init_mod.Xavier())
        b = _bias(num_total_classes, input.dtype, bias_attr)
        return on.nce_loss(input, w, b, label, num_neg_samples, rng, num_total_classes)


def hsigmoid(
    input: torch.Tensor,
    label: torch.Tensor,
    num_classes: int,
    param_attr=None,
    bias_attr=None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """fluid ``layers.hsigmoid`` (reference ``hierarchical_sigmoid_op.cc``):
    complete-binary-tree hierarchical softmax over [num_classes - 1, D]
    internal-node weights ``w`` (Xavier) and ``b``."""
    d = input.shape[-1]
    with name_scope(name or "hsigmoid"):
        w = create_parameter([num_classes - 1, d], input.dtype, name="w", attr=param_attr,
                             default_initializer=init_mod.Xavier())
        b = _bias(num_classes - 1, input.dtype, bias_attr)
        return on.hsigmoid_loss(input, w, b, label, num_classes)


def row_conv(
    input: torch.Tensor,
    future_context_size: int,
    lengths: Optional[torch.Tensor] = None,
    param_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """fluid ``layers.row_conv`` (reference ``row_conv_op.cc``): ``w``
    [future_context_size + 1, D] (Xavier)."""
    d = input.shape[-1]
    with name_scope(name or "row_conv"):
        w = create_parameter([future_context_size + 1, d], input.dtype, name="w",
                             attr=param_attr, default_initializer=init_mod.Xavier())
        return _act(on.row_conv(input, w, lengths), act)


# ---------------------------------------------------------------------------
# RNN units
# ---------------------------------------------------------------------------


def gru_unit(
    input: torch.Tensor,
    hidden: torch.Tensor,
    size: int,
    param_attr=None,
    bias_attr=None,
    name: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fluid ``layers.gru_unit`` (reference ``gru_unit_op.cc``): one GRU
    step. ``size`` is 3*H (fluid contract); ``input`` [B, 3H] is the
    pre-projected input. Creates the [H, 3H] recurrent weight ``w`` and the
    [3H] bias ``b``. Returns (new_hidden, new_hidden)."""
    h = size // 3
    enforce(hidden.shape[-1] == h, f"hidden dim {hidden.shape[-1]} != size/3 {h}")
    with name_scope(name or "gru_unit"):
        w = create_parameter([h, 3 * h], input.dtype, name="w", attr=param_attr,
                             default_initializer=init_mod.Xavier())
        new_h, _ = orn.gru_unit(input, hidden, w, _bias(3 * h, input.dtype, bias_attr))
        return new_h, new_h


def lstm_unit(
    x_t: torch.Tensor,
    hidden_t_prev: torch.Tensor,
    cell_t_prev: torch.Tensor,
    forget_bias: float = 0.0,
    param_attr=None,
    bias_attr=None,
    name: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fluid ``layers.lstm_unit`` (reference ``lstm_unit_op.cc`` via an fc on
    concat(x, h)): one LSTM step with ``w`` [D + H, 4H] and ``b``; returns
    (hidden, cell). The projection takes its operands as given (f32
    accumulation), as the JAX package's does."""
    d = x_t.shape[-1]
    h = hidden_t_prev.shape[-1]
    with name_scope(name or "lstm_unit"):
        w = create_parameter([d + h, 4 * h], x_t.dtype, name="w", attr=param_attr,
                             default_initializer=init_mod.Xavier())
        bias = _bias(4 * h, x_t.dtype, bias_attr)
        proj = dmod.f32_product(torch.cat([x_t, hidden_t_prev], dim=-1), w).to(x_t.dtype)
        st = orn.lstm_cell(proj, orn.LSTMState(hidden_t_prev, cell_t_prev),
                           torch.zeros((h, 4 * h), dtype=x_t.dtype, device=x_t.device),
                           bias, forget_bias)
        return st.h, st.c


def dynamic_lstmp(
    input: torch.Tensor,
    size: int,
    proj_size: int,
    lengths: Optional[torch.Tensor] = None,
    param_attr=None,
    bias_attr=None,
    cell_clip: Optional[float] = None,
    proj_clip: Optional[float] = None,
    proj_activation: Optional[str] = None,
    name: Optional[str] = None,
):
    """fluid ``layers.dynamic_lstmp`` (reference ``lstmp_op.cc``): projected
    LSTM over a padded batch. ``size`` is 4*H; ``input`` [B, T, 4H] is
    pre-projected (fluid contract). ``w`` [P, 4H], ``w_proj`` [H, P], ``b``.
    Returns (proj_out [B, T, P], final state)."""
    h = size // 4
    with name_scope(name or "dynamic_lstmp"):
        w_hh = create_parameter([proj_size, 4 * h], input.dtype, name="w", attr=param_attr,
                                default_initializer=init_mod.Xavier())
        w_proj = create_parameter([h, proj_size], input.dtype, name="w_proj", attr=param_attr,
                                  default_initializer=init_mod.Xavier())
        return orn.dynamic_lstmp(input, None, w_hh, w_proj, _bias(4 * h, input.dtype, bias_attr),
                                 lengths, cell_clip=cell_clip, proj_clip=proj_clip,
                                 proj_act=proj_activation)


# ---------------------------------------------------------------------------
# Tensor helpers (reference layers/tensor.py)
# ---------------------------------------------------------------------------


def assign(input, device=None) -> torch.Tensor:
    """fluid ``layers.assign`` (reference ``assign_op.cc``): a tensor is
    returned as is; anything else (numpy, lists) becomes a tensor on
    ``device`` (by default the running apply's device, else CUDA)."""
    if isinstance(input, torch.Tensor):
        return input
    return torch.as_tensor(input, device=om._device(device))


def create_tensor(dtype="float32", name: Optional[str] = None, device=None) -> torch.Tensor:
    """fluid ``layers.create_tensor``: there are no empty variables here, so
    a 0-d zero of ``dtype`` stands in for later ``assign``-style use."""
    return torch.zeros((), dtype=dmod.convert(dtype), device=om._device(device))


def create_global_var(
    shape: Sequence[int], value: float, dtype="float32",
    persistable: bool = False, name: Optional[str] = None,
) -> torch.Tensor:
    """fluid ``layers.create_global_var``: a named mutable state entry (the
    startup-program global var analogue); lives in Model state."""
    return create_state(name or "global_var", shape, dtype,
                        init=lambda s, d: torch.full(s, value, dtype=d))


def fill_constant_batch_size_like(input: torch.Tensor, shape: Sequence[int], dtype, value):
    """Reference ``fill_constant_batch_size_like_op.cc``: constant tensor
    whose leading dim tracks the batch size of ``input`` (on its device)."""
    shp = (input.shape[0],) + tuple(int(s) for s in shape[1:])
    return torch.full(shp, value, dtype=dmod.convert(dtype), device=input.device)


def sums(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Reference ``sum_op.cc`` n-ary add."""
    out = inputs[0]
    for x in inputs[1:]:
        out = out + x
    return out


def is_empty(x: torch.Tensor) -> bool:
    """Reference ``is_empty_op.cc``: whether ``x`` has no elements (a
    Python bool: shapes are known on the host)."""
    return x.numel() == 0


def autoincreased_step_counter(counter_name: str = "@STEP_COUNTER@", begin: int = 1,
                               step: int = 1) -> torch.Tensor:
    """Reference ``layers/nn.py`` autoincreased_step_counter: a persistent
    counter in the model state, bumped every apply (``begin`` on the first);
    int64 (``INDEX_DTYPE``; int32 in the JAX package without x64)."""
    cur = create_state(counter_name, (), dmod.INDEX_DTYPE,
                       init=lambda s, d: torch.full(s, begin - step, dtype=d))
    new = cur + step
    update_state(counter_name, new)
    return new


def Print(input: torch.Tensor, message: str = "", summarize: int = -1, **_ignored) -> torch.Tensor:
    """fluid ``layers.Print`` (reference ``print_op.cc``): print ``message``
    and the tensor (on CUDA a device-to-host copy), return the input
    unchanged."""
    print(f"{message}{input}", flush=True)
    return input


# ---------------------------------------------------------------------------
# Block-style control-flow adapters
# ---------------------------------------------------------------------------


class While:
    """Functional adapter for fluid's block-style ``While`` (reference
    ``layers/control_flow.py`` While / ``while_op.cc:36``): the loop body is
    a function, ``While(cond_fn)(body_fn, init_vars)``."""

    def __init__(self, cond: Callable):
        self.cond = cond

    def __call__(self, body: Callable, loop_vars):
        return ocf.while_loop(self.cond, body, loop_vars)


class Switch:
    """Functional adapter for fluid ``Switch`` blocks: accumulate
    (condition, fn) cases, then ``build(*operands)`` evaluates the first
    true branch (reference ``layers/control_flow.py`` Switch)."""

    def __init__(self):
        self._cases = []
        self._default: Optional[Callable] = None

    def case(self, condition, fn: Callable) -> "Switch":
        self._cases.append((condition, fn))
        return self

    def default(self, fn: Callable) -> "Switch":
        self._default = fn
        return self

    def build(self, *operands):
        return ocf.case(self._cases, self._default, *operands)


class IfElse:
    """Functional adapter for fluid ``IfElse`` (reference
    ``conditional_block_op.cc``): IfElse(pred)(true_fn, false_fn, *ops)."""

    def __init__(self, pred):
        self.pred = pred

    def __call__(self, true_fn: Callable, false_fn: Callable, *operands):
        return ocf.cond(self.pred, true_fn, false_fn, *operands)


class StaticRNN:
    """Adapter over :func:`paddle_tpu_torch.ops.control_flow.static_rnn`:
    fluid's step-block becomes ``step(carry, x_t) -> (carry, out)``, and
    ``StaticRNN(step)(init_carry, xs_time_major)`` steps over the leading
    axis of ``xs_time_major``. (The JAX package's adapter passes the two
    arguments to ``static_rnn`` the other way round, ROADMAP §C.)"""

    def __init__(self, step: Callable):
        self.step = step

    def __call__(self, init_carry, xs_time_major):
        return ocf.static_rnn(self.step, xs_time_major, init_carry, time_major=True)


class DynamicRNN:
    """Adapter over :func:`paddle_tpu_torch.ops.control_flow.dynamic_rnn` —
    the length-masked loop (the LoD-aware dynamic RNN, reference
    ``recurrent_op.cc``): ``DynamicRNN(step)(init_carry, xs, lengths)`` over
    batch-major ``xs`` [B, T, ...]. (The JAX package's adapter passes the
    arguments to ``dynamic_rnn`` in another order, ROADMAP §C.)"""

    def __init__(self, step: Callable):
        self.step = step

    def __call__(self, init_carry, xs, lengths):
        return ocf.dynamic_rnn(self.step, xs, lengths, init_carry)


# ---------------------------------------------------------------------------
# Metric ops (reference layers/metric_op.py)
# ---------------------------------------------------------------------------


def auc(input: torch.Tensor, label: torch.Tensor, num_thresholds: int = 200) -> torch.Tensor:
    """Batch ROC-AUC (reference ``auc_op.cc``): threshold-bucketed TP/FP
    counting and the trapezoid sum over the ROC points, ordered by FPR then
    TPR (the staircase's upper boundary, as the JAX package's lexsort)."""
    pos_prob = input[:, 1] if input.dim() == 2 and input.shape[1] == 2 else input.reshape(-1)
    lab = label.reshape(-1).float()
    thresholds = torch.arange(num_thresholds, dtype=torch.float32,
                              device=input.device) / (num_thresholds - 1)
    pred = (pos_prob.reshape(-1)[None, :] >= thresholds[:, None]).float()  # [T, B]
    tp = torch.sum(pred * lab[None, :], dim=1)
    fp = torch.sum(pred * (1.0 - lab[None, :]), dim=1)
    # label counts: not differentiated
    tpr = tp / torch.clamp_min(torch.sum(lab), 1e-6)
    fpr = fp / torch.clamp_min(torch.sum(1.0 - lab), 1e-6)
    order = torch.sort(tpr, stable=True).indices  # lexsort: by fpr, ties by tpr
    order = order[torch.sort(fpr[order], stable=True).indices]
    fpr_s, tpr_s = fpr[order], tpr[order]
    return torch.sum((fpr_s[1:] - fpr_s[:-1]) * 0.5 * (tpr_s[1:] + tpr_s[:-1]))


def chunk_eval(
    inferred: torch.Tensor,
    label: torch.Tensor,
    lengths: torch.Tensor,
    num_chunk_types: int,
    chunk_scheme: str = "IOB",
):
    """Chunk-level precision/recall counting (reference ``chunk_eval_op.cc``,
    IOB scheme): a chunk of type c starts at B-c or at I-c following a
    different type; two chunks match when (start, end, type) all agree.
    Tags encode as ``type * 2 + tag`` with tag B=0, I=1; ``O`` is the single
    id ``num_chunk_types * 2``. Returns (num_infer_chunks, num_label_chunks,
    num_correct_chunks) int32 scalars."""
    enforce(chunk_scheme == "IOB", "only IOB scheme is implemented")
    t = inferred.shape[1]
    valid = oseq.length_mask(lengths.to(inferred.device), t)

    def starts_types(tags):
        tags = tags.long()
        is_o = (tags >= num_chunk_types * 2) | (tags < 0)
        typ = torch.where(is_o, -1, torch.div(tags, 2, rounding_mode="floor"))
        is_b = (~is_o) & (tags % 2 == 0)
        prev_typ = torch.nn.functional.pad(typ[:, :-1], (1, 0), value=-1)
        return valid & (~is_o) & (is_b | (typ != prev_typ)), typ

    def end_marks(start, typ):
        # for each t, the smallest boundary position > t (t + 1 if none)
        idx = torch.arange(t, device=start.device)[None, :]
        big = torch.where(start | ~valid | (typ < 0), idx, t + 1)
        nxt = torch.flip(torch.cummin(torch.flip(big, (1,)), dim=1).values, (1,))
        return torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], t + 1)], dim=1)

    si, ti = starts_types(inferred)
    sl, tl = starts_types(label)
    correct = si & sl & (ti == tl) & (end_marks(si, ti) == end_marks(sl, tl))
    return tuple(torch.sum(m.to(torch.int32)).to(torch.int32) for m in (si, sl, correct))

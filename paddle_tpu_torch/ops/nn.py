"""Neural-network ops — port of ``paddle_tpu/ops/nn.py``: conv (plain,
depthwise, transposed), pooling and adaptive pooling, batch/layer/group
norm and LRN, softmax and the losses (cross entropy, smooth L1, Huber, KL,
log, rank, dice, NCE, hierarchical sigmoid), accuracy and mean IoU,
embedding lookup and its dense gradient, dropout, one-hot and label
smoothing, padding, resizing, pixel shuffle, row conv.

Images are NHWC and conv weights HWIO at the API, as in the JAX package
(``paddle_tpu/ops/nn.py:10,89``); the conv and pooling ops permute to
PyTorch's NCHW/OIHW at their boundary and run cuDNN's kernels on the card
(the JAX package leaves them to XLA, so no hand-written kernel is owed).
Padding, stride and dilation read as the reference reads them: an int or
pair pads both sides of each axis, ``"SAME"``/``"VALID"`` as in XLA (SAME
puts the odd extra row on the high side). Losses reduce in f32. Batch
norm keeps its statistics in f32 over N·H·W with the biased variance, as
the reference does; on the card it runs PyTorch's fused kernel and takes
the moving statistics from the batch statistics that kernel saves.
"""

from __future__ import annotations

import math as _math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import compute_dtype, f32_product, ieee_f32, mxu_operands
from paddle_tpu_torch.ops import math as om
from paddle_tpu_torch.parallel import context as dp_context

__all__ = [
    "conv2d", "conv2d_transpose", "depthwise_conv2d", "maxout", "pool2d", "adaptive_pool2d",
    "batch_norm_infer", "batch_norm_train", "layer_norm", "group_norm", "lrn", "softmax",
    "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "square_error_cost", "smooth_l1", "huber_loss",
    "kldiv_loss", "log_loss", "margin_rank_loss", "dropout", "one_hot", "label_smooth",
    "accuracy", "embedding_lookup", "embedding_grad_dense", "prelu", "pixel_shuffle", "pad2d",
    "resize_nearest", "resize_bilinear", "cos_sim", "l2_normalize", "matmul_bias", "multiplex",
    "row_conv", "pad_constant_like", "rank_loss", "dice_loss", "mean_iou", "nce_loss",
    "hsigmoid_loss",
]

_IntOrPair = Union[int, Sequence[int]]


def _pair(v: _IntOrPair) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _same_pads(size: int, k: int, s: int, d: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: output ceil(size / s), the odd extra
    row on the high side."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


class _F32Conv(torch.autograd.Function):
    """An f32 convolution on CUDA (2-D or 3-D, plain or transposed) whose
    forward and backward both run under
    :func:`~paddle_tpu_torch.core.dtypes.ieee_f32`: cuDNN reads its TF32
    switch when each kernel runs, and autograd runs the backward after any
    ``with`` around the forward has exited."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups, transposed, output_padding):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, transposed, output_padding, groups)
        with ieee_f32():
            return torch.ops.aten.convolution(x, w, None, stride, padding, dilation, transposed,
                                              output_padding, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with ieee_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(g, x, w, None, *ctx.conf, mask)
        return dx, dw, None, None, None, None, None, None


def convolution(xn, wn, stride, padding, dilation=None, groups: int = 1, transposed: bool = False,
                output_padding=None):
    """``aten.convolution`` over channels-first operands (NC…, and OI… or,
    transposed, IO… weights) of any spatial rank; f32 operands on CUDA
    through :class:`_F32Conv` (full f32, forward and backward)."""
    nd = xn.dim() - 2
    dilation = dilation or (1,) * nd
    output_padding = output_padding or (0,) * nd
    conf = (tuple(stride), tuple(padding), tuple(dilation), groups, transposed, tuple(output_padding))
    if xn.is_cuda and xn.dtype == torch.float32:
        return _F32Conv.apply(xn, wn, *conf)
    stride, padding, dilation, groups, transposed, output_padding = conf
    return torch.ops.aten.convolution(xn, wn, None, stride, padding, dilation, transposed,
                                      output_padding, groups)


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: _IntOrPair = 1,
    padding: Union[str, _IntOrPair] = 0,
    dilation: _IntOrPair = 1,
    groups: int = 1,
) -> torch.Tensor:
    """2-D convolution, NHWC activations × HWIO weights (reference
    ``operators/conv_op.cc``): a convolution (:func:`convolution`) on the
    operands in the compute dtype (bf16 under ``use_bf16_compute``), result
    in x's dtype. f32 operands on CUDA convolve in full f32, forward and
    backward (:class:`_F32Conv`; the rule is in
    :mod:`paddle_tpu_torch.core.dtypes`).

    Layout: the NHWC activation seen as NCHW is a channels-last view, and
    the weight is cast and copied once into OHWI order, so that its OIHW
    view is channels-last too: cuDNN takes both without another copy."""
    cdt = compute_dtype()
    xc = x.to(cdt) if x.is_floating_point() else x
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    xn = xc.permute(0, 3, 1, 2)
    wn = weight.permute(3, 0, 1, 2).to(cdt, memory_format=torch.contiguous_format).permute(0, 3, 1, 2)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME', 'VALID' or ints, got {padding!r}")
        pad = (0, 0)
        if mode == "SAME":
            ph = _same_pads(x.shape[1], weight.shape[0], sh, dh)
            pw = _same_pads(x.shape[2], weight.shape[1], sw, dw)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]))
    else:
        pad = _pair(padding)
    out = convolution(xn, wn, (sh, sw), pad, (dh, dw), groups)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def pool2d(
    x: torch.Tensor,
    pool_size: _IntOrPair = 2,
    pool_type: str = "max",
    pool_stride: _IntOrPair = 1,
    pool_padding: _IntOrPair = 0,
    ceil_mode: bool = False,
    exclusive: bool = True,
    global_pooling: bool = False,
) -> torch.Tensor:
    """Max/avg pooling over NHWC (reference ``pool_op.cc`` semantics incl.
    ``exclusive`` average counting): the input is padded explicitly (-inf
    for max, 0 for avg; ``ceil_mode`` pads the high side until the last
    window is complete), then pooled with no further padding."""
    if global_pooling:
        pool_size = (x.shape[1], x.shape[2])
        pool_padding = 0
    kh, kw = _pair(pool_size)
    sh, sw = _pair(pool_stride)
    ph, pw = _pair(pool_padding)
    if ceil_mode:
        def extra(size, k, s, p):
            out = -(-(size + 2 * p - k) // s) + 1  # ceil
            return max(0, (out - 1) * s + k - (size + 2 * p))

        eh, ew = extra(x.shape[1], kh, sh, ph), extra(x.shape[2], kw, sw, pw)
    else:
        eh = ew = 0
    pads = (pw, pw + ew, ph, ph + eh)  # F.pad order: W low/high, then H
    xn = x.permute(0, 3, 1, 2)
    if pool_type == "max":
        padded = F.pad(xn, pads, value=-float("inf")) if any(pads) else xn
        out = F.max_pool2d(padded, (kh, kw), (sh, sw))
    elif pool_type == "avg":
        padded = F.pad(xn.float(), pads, value=0.0) if any(pads) else xn.float()
        summed = F.avg_pool2d(padded, (kh, kw), (sh, sw), divisor_override=1)
        if exclusive and (ph or pw or eh or ew):
            ones = F.pad(torch.ones((1, 1) + tuple(x.shape[1:3]), device=x.device), pads)
            counts = F.avg_pool2d(ones, (kh, kw), (sh, sw), divisor_override=1)
            out = summed / counts
        else:
            out = summed / float(kh * kw)
        out = out.to(x.dtype)
    else:
        raise ValueError(f"pool_type must be 'max' or 'avg', got {pool_type!r}")
    return out.permute(0, 2, 3, 1)


def adaptive_pool2d(x: torch.Tensor, output_size: _IntOrPair, pool_type: str = "avg") -> torch.Tensor:
    """Reference ``pool_op.cc`` adaptive mode over NHWC: output bin i spans
    [floor(i*H/oh), ceil((i+1)*H/oh)). Divisible sizes are a plain strided
    pool; other sizes take the JAX package's exact paths: avg contracts
    each axis with a bin-membership matrix whose rows are scaled by
    1/bin size, max gathers each bin padded to the longest bin by repeating
    an in-bin element (duplicates never change a max)."""
    oh, ow = _pair(output_size)
    h, w = x.shape[1], x.shape[2]
    if h % oh == 0 and w % ow == 0:
        return pool2d(x, (h // oh, w // ow), pool_type, (h // oh, w // ow))

    def edges(in_size, out_size):
        return [((i * in_size) // out_size, -(-((i + 1) * in_size) // out_size))
                for i in range(out_size)]

    eh, ew = edges(h, oh), edges(w, ow)
    if pool_type == "avg":
        def weight(in_size, bins):
            m = torch.zeros((len(bins), in_size), dtype=torch.float32)
            for i, (s, e) in enumerate(bins):
                m[i, s:e] = 1.0 / (e - s)
            return m.to(x.device)

        out = torch.einsum("ih,bhwc->biwc", weight(h, eh), x.float())
        out = torch.einsum("jw,biwc->bijc", weight(w, ew), out)
        return out.to(x.dtype)
    if pool_type == "max":
        def gather_max(arr, axis, bins):
            longest = max(e - s for s, e in bins)
            idx = torch.tensor([[min(s + l, e - 1) for l in range(longest)] for s, e in bins],
                               device=x.device)
            g = torch.index_select(arr, axis, idx.reshape(-1))
            g = g.reshape(arr.shape[:axis] + idx.shape + arr.shape[axis + 1:])
            return g.amax(dim=axis + 1)

        return gather_max(gather_max(x, 1, eh), 2, ew)
    raise ValueError(f"pool_type must be 'max' or 'avg', got {pool_type!r}")


def _batch_norm_stats_plain(x, scale, bias, epsilon):
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, correction=0)
    y = (xf - mean) * torch.rsqrt(var + epsilon) * scale.float() + bias.float()
    return y, mean, var


def _batch_norm_stats_fused(x, scale, bias, epsilon):
    """The same on the card: PyTorch's fused batch norm over the channels-last
    NCHW view of the NHWC input (no running statistics passed, so none are
    updated); the batch variance is recovered from the saved inverse
    standard deviation, 1/sqrt(var + eps), which holds the biased one."""
    xn = x.float().movedim(-1, 1)
    y, mean, invstd = torch.ops.aten.native_batch_norm(
        xn, scale.float(), bias.float(), None, None, True, 0.0, epsilon)
    with torch.no_grad():
        var = invstd.reciprocal().square() - epsilon
    return y.movedim(1, -1), mean, var


class _GlobalBatchNormStats(torch.autograd.Function):
    """Training-mode BN whose statistics span the data-parallel group (the
    JAX package's statistics over the global batch under ``DataParallel``):
    the per-channel sums, the count and the centred squares are summed over
    the group, and the backward sums its two gradient terms (Σ dy and
    Σ dy·x̂) over the group too, as SyncBatchNorm does; the scale's and
    bias's gradients stay the rank's own (the step averages them)."""

    @staticmethod
    def forward(ctx, x, scale, bias, epsilon, group):
        c = x.shape[-1]
        x2 = x.float().reshape(-1, c)
        sums = torch.cat([x2.sum(0), x2.new_tensor([x2.shape[0]])])
        group.all_reduce_(sums)
        n = sums[c]
        mean = sums[:c] / n
        xc = x2 - mean
        var = group.all_reduce_((xc * xc).sum(0)) / n
        invstd = torch.rsqrt(var + epsilon)
        xhat = xc * invstd
        y = xhat * scale.float() + bias.float()
        ctx.save_for_backward(xhat, invstd, scale, n)
        ctx.group, ctx.shape, ctx.dtype = group, x.shape, x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.reshape(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, scale, n = ctx.saved_tensors
        c = xhat.shape[-1]
        dy2 = dy.float().reshape(-1, c)
        dbias = dy2.sum(0)
        dscale = (dy2 * xhat).sum(0)
        g = ctx.group.all_reduce_(torch.cat([dbias, dscale]))
        dx = (scale.float() * invstd) * (dy2 - g[:c] / n - xhat * (g[c:] / n))
        return dx.reshape(ctx.shape).to(ctx.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype), None, None


def batch_norm_train(x, scale, bias, moving_mean, moving_var, momentum: float = 0.9,
                     epsilon: float = 1e-5):
    """Training-mode BN over all but the channel (last) axis. Returns
    ``(y, new_moving_mean, new_moving_var, batch_mean, batch_var)`` — the
    functional split of the reference's in-place statistics update
    (``operators/batch_norm_op.cc``): f32 statistics over N·H·W, the biased
    variance, ``new = momentum * old + (1 - momentum) * batch``. The
    statistics carry no graph: gradients flow through ``y`` only (through
    the batch statistics inside it, as in the reference). CUDA tensors take
    :func:`_batch_norm_stats_fused`, CPU tensors the plain composition;
    inside a data-parallel step the statistics span its group
    (:class:`_GlobalBatchNormStats`)."""
    group = dp_context.active()
    if group is not None:
        y, mean, var = _GlobalBatchNormStats.apply(x, scale, bias, epsilon, group)
    else:
        fn = _batch_norm_stats_fused if x.is_cuda else _batch_norm_stats_plain
        y, mean, var = fn(x, scale, bias, epsilon)
    with torch.no_grad():
        mean, var = mean.detach(), var.detach()
        new_mean = momentum * moving_mean + (1 - momentum) * mean
        new_var = momentum * moving_var + (1 - momentum) * var
    return y.to(x.dtype), new_mean, new_var, mean, var


def batch_norm_infer(x, scale, bias, moving_mean, moving_var, epsilon: float = 1e-5):
    """Inference-mode BN with the moving statistics, in f32, result in x's
    dtype."""
    inv = torch.rsqrt(moving_var.float() + epsilon)
    y = (x.float() - moving_mean.float()) * inv * scale.float() + bias.float()
    return y.to(x.dtype)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x.float(), dim=axis).to(x.dtype)


def _hard_labels(label: torch.Tensor, ref_dim: int) -> torch.Tensor:
    return label.squeeze(-1) if (label.dim() == ref_dim and label.shape[-1] == 1) else label


def cross_entropy(probs, label, soft_label: bool = False, ignore_index: int = -100, axis: int = -1):
    """NLL on probabilities (reference ``cross_entropy_op.cc``): input is a
    probability distribution (post-softmax); label is int ids or soft dist.
    Returns per-example loss with a trailing 1 dim (fluid convention)."""
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's
    logp = torch.log(probs.float().clamp_min(1e-10))
    if soft_label:
        return -torch.sum(label.float() * logp, dim=axis, keepdim=True)
    lab = _hard_labels(label, probs.dim())
    keep = lab != ignore_index
    picked = torch.gather(logp, axis, torch.where(keep, lab, 0)[..., None].long())
    return torch.where(keep[..., None], -picked, 0.0)


def softmax_with_cross_entropy(
    logits, label, soft_label: bool = False, ignore_index: int = -100, return_softmax: bool = False
):
    """Fused, numerically-stable version (reference
    ``softmax_with_cross_entropy_op.cc``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if soft_label:
        loss = -torch.sum(label.float() * logp, dim=-1, keepdim=True)
    else:
        lab = _hard_labels(label, logits.dim())
        keep = lab != ignore_index  # ignored rows gather class 0, then read 0
        picked = torch.gather(logp, -1, torch.where(keep, lab, 0)[..., None].long())
        loss = torch.where(keep[..., None], -picked, 0.0)
    if return_softmax:
        return loss, torch.exp(logp).to(logits.dtype)
    return loss


def square_error_cost(input, label):
    return torch.square(input.float() - label.float())


def one_hot(x, depth: int, dtype="float32"):
    """Reference ``one_hot_op.cc``: int ids (a trailing 1 dim allowed) →
    [..., depth] in ``dtype``; ids outside [0, depth) give all-zero rows, as
    ``jax.nn.one_hot`` does."""
    from paddle_tpu_torch.core.dtypes import convert

    ids = x.squeeze(-1) if (x.dim() >= 2 and x.shape[-1] == 1) else x
    ids = torch.as_tensor(ids).long()
    classes = torch.arange(depth, device=ids.device)
    return (ids[..., None] == classes).to(convert(dtype))


def label_smooth(label, epsilon: float = 0.1):
    """Reference ``label_smooth_op.cc``: ``(1 - eps) * label + eps / K``
    over the last (class) axis of K."""
    k = label.shape[-1]
    return (1 - epsilon) * label + epsilon / k


def accuracy(logits_or_topk, label, k: int = 1):
    """Reference ``accuracy_op.cc``: fraction of rows whose top-k contains
    the label."""
    lab = label.squeeze(-1) if (label.dim() >= 2 and label.shape[-1] == 1) else label
    idx = torch.topk(logits_or_topk, k, dim=-1).indices
    correct = torch.any(idx == lab[..., None].long(), dim=-1)
    return torch.mean(correct.float())


def layer_norm(x, scale=None, bias=None, begin_norm_axis: int = -1, epsilon: float = 1e-5):
    """Reference ``layer_norm_op.cc``: normalize over dims
    [begin_norm_axis, rank), in f32, result in x's dtype."""
    if begin_norm_axis < 0:
        begin_norm_axis = x.dim() + begin_norm_axis
    axes = tuple(range(begin_norm_axis, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def dropout(x, dropout_prob: float, is_test: bool = False, generator=None,
            upscale_in_train: bool = True, block=None):
    """Reference ``dropout_op.cc``. ``upscale_in_train`` is the
    'upscale_in_train' dropout_implementation (the modern default): kept
    entries are divided by the keep rate in training, and eval leaves x
    unchanged. The mask is Bernoulli(1 - dropout_prob) from ``generator``,
    by default the frame's (``framework.next_rng``, which raises when the
    training-mode apply was given no ``rng``); it is drawn on the
    generator's device. ``Model.init`` draws nothing: its outputs are
    discarded. ``block=(dim, index, n)``: ``x`` is block ``index`` of ``n``
    on ``dim`` of a tensor split over ranks (tensor parallelism); the mask
    is drawn at the whole tensor's shape and cut alike, so the ranks'
    masks join into the one-device mask."""
    if is_test:
        return x if upscale_in_train else x * (1.0 - dropout_prob)
    if dropout_prob == 0.0:
        return x
    if generator is None:
        from paddle_tpu_torch import framework

        if framework.is_initializing():
            return x
        generator = framework.next_rng()
    keep = 1.0 - dropout_prob
    if block is None:
        u = torch.rand(x.shape, generator=generator, device=generator.device)
    else:
        dim, index, n = block
        dim %= x.dim()
        shape = list(x.shape)
        shape[dim] *= n
        u = torch.rand(shape, generator=generator, device=generator.device)
        u = u.narrow(dim, index * x.shape[dim], x.shape[dim])
    mask = (u < keep).to(x.device)
    if upscale_in_train:
        return torch.where(mask, x / keep, 0).to(x.dtype)
    return torch.where(mask, x, 0).to(x.dtype)


def embedding_lookup(table, ids, padding_idx: Optional[int] = None):
    """Reference ``lookup_table_op.cc``. ids may carry a trailing 1 dim
    (LoD-style); padding_idx rows produce zeros."""
    ids2 = ids.squeeze(-1) if (ids.dim() >= 2 and ids.shape[-1] == 1) else ids
    out = table[ids2.long()]
    if padding_idx is not None:
        out = torch.where((ids2 == padding_idx)[..., None], 0.0, out)
    return out


# -- the rest of the catalog --------------------------------------------------

def depthwise_conv2d(x, weight, stride=1, padding=0, dilation=1):
    """Depthwise conv (reference ``operators/math/depthwise_conv.cu``):
    groups == channels; weight [kh, kw, 1, C * multiplier]."""
    return conv2d(x, weight, stride, padding, dilation, groups=x.shape[-1])


def conv2d_transpose(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: _IntOrPair = 1,
    padding: _IntOrPair = 0,
    output_padding: _IntOrPair = 0,
) -> torch.Tensor:
    """Transposed conv (reference ``conv_transpose_op.cc``), NHWC x, HWIO
    weight with I = in_channels of x, O = out_channels; output size
    (in - 1) * stride - 2 * padding + k + output_padding. The JAX package
    convolves the stride-dilated input with the spatially flipped kernel;
    that is the adjoint of a strided convolution, which is what
    ``aten.convolution(transposed=True)`` computes, with the weight seen as
    [I, O, kh, kw]. Operands in the compute dtype; f32 on the card in full
    f32 (:func:`convolution`). ``output_padding`` must be below the stride,
    as PyTorch's transposed convolution requires."""
    cdt = compute_dtype()
    sh, sw = _pair(stride)
    oph, opw = _pair(output_padding)
    if oph >= sh or opw >= sw:
        raise ValueError(f"conv2d_transpose: output_padding {(oph, opw)} must be below the "
                         f"stride {(sh, sw)}")
    xn = x.to(cdt).permute(0, 3, 1, 2)
    wn = weight.to(cdt).permute(2, 3, 0, 1)
    out = convolution(xn, wn, (sh, sw), _pair(padding), None, 1, True, (oph, opw))
    return out.permute(0, 2, 3, 1).to(x.dtype)


def maxout(x, groups: int):
    """Maxout over channel groups (reference ``maxout_op.cc``), NHWC: output
    channel ``i`` is ``max_k x[..., i*groups + k]``."""
    c = x.shape[-1]
    if c % groups:
        raise ValueError(f"maxout: channels {c} not divisible by groups {groups}")
    return x.reshape(tuple(x.shape[:-1]) + (c // groups, groups)).amax(dim=-1)


def group_norm(x, scale=None, bias=None, groups: int = 32, epsilon: float = 1e-5):
    """Group norm over the spatial dims and each group of the last-axis
    channels, in f32, result in x's dtype."""
    n, c = x.shape[0], x.shape[-1]
    spatial = tuple(x.shape[1:-1])
    xf = x.float().reshape((n,) + spatial + (groups, c // groups))
    axes = tuple(range(1, xf.dim() - 2)) + (xf.dim() - 1,)
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, keepdim=True, correction=0)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def lrn(x, n: int = 5, k: float = 1.0, alpha: float = 1e-4, beta: float = 0.75):
    """Local response norm across channels, NHWC (reference ``lrn_op.cc``):
    x / (k + alpha * Σ x² over the n channels centred on each)^beta."""
    xf = x.float()
    half = n // 2
    window = F.pad(torch.square(xf), (half, half)).unfold(-1, n, 1).sum(-1)
    return (xf / torch.pow(k + alpha * window, beta)).to(x.dtype)


def l2_normalize(x, axis: int = -1, epsilon: float = 1e-12):
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's
    return x / norm.clamp_min(epsilon)


def log_softmax(x, axis: int = -1):
    return torch.log_softmax(x.float(), dim=axis).to(x.dtype)


def sigmoid_cross_entropy_with_logits(x, label):
    """max(x, 0) - x * label + log(1 + e^-|x|), with the JAX package's
    kinks: at a logit of exactly 0 the gradient is -label (the true
    derivative is 0.5 - label; ROADMAP §C.10)."""
    xf, lf = x.float(), label.float()
    return om.maximum(xf, 0.0) - xf * lf + torch.log1p(torch.exp(-om.abs(xf)))


def smooth_l1(x, y, sigma: float = 1.0):
    """Reference ``smooth_l1_loss_op.cc``: per-example summed smooth-L1."""
    s2 = sigma * sigma
    d = om.abs(x.float() - y.float())
    loss = torch.where(d < 1.0 / s2, 0.5 * s2 * torch.square(d), d - 0.5 / s2)
    return torch.sum(loss.reshape(loss.shape[0], -1), dim=1, keepdim=True)


def huber_loss(x, y, delta: float = 1.0):
    d = om.abs(x.float() - y.float())
    return torch.where(d <= delta, 0.5 * torch.square(d), delta * (d - 0.5 * delta))


def kldiv_loss(x, target):
    """x is log-probabilities, target probabilities."""
    tf = target.float()
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's
    return tf * (torch.log(tf.clamp_min(1e-10)) - x.float())


def log_loss(input, label, epsilon: float = 1e-4):
    p, lf = input.float(), label.float()
    return -lf * torch.log(p + epsilon) - (1 - lf) * torch.log(1 - p + epsilon)


def margin_rank_loss(label, left, right, margin: float = 0.1):
    return om.maximum(-label * (left - right) + margin, 0.0)


def cos_sim(x, y):
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's
    return torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn).clamp_min(1e-12)


def embedding_grad_dense(table_shape, ids, grad_out):
    """Dense embedding gradient by scatter-add (the reference emitted
    SelectedRows sparse gradients, ``lookup_table_op.cc``); equal to
    autograd's gradient of :func:`embedding_lookup`."""
    ids2 = ids.reshape(-1).long()
    g = grad_out.reshape(-1, table_shape[-1])
    return torch.zeros(tuple(table_shape), dtype=g.dtype, device=g.device).index_add(0, ids2, g)


def prelu(x, alpha, mode: str = "all"):
    return torch.where(x >= 0, x, alpha * x)


def pixel_shuffle(x, upscale_factor: int):
    n, h, w, c = x.shape
    r = upscale_factor
    oc = c // (r * r)
    x = x.reshape(n, h, w, r, r, oc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, oc)


def pad2d(x, paddings: Sequence[int], mode: str = "constant", pad_value: float = 0.0):
    """NHWC spatial padding: paddings = [top, bottom, left, right]; modes
    constant, reflect (mirror without the edge) and edge."""
    top, bottom, left, right = (int(p) for p in paddings)
    if mode == "constant":
        return F.pad(x, (0, 0, left, right, top, bottom), value=pad_value)
    torch_mode = {"reflect": "reflect", "edge": "replicate"}[mode]
    xn = x.permute(0, 3, 1, 2)
    if not xn.is_floating_point():
        raise TypeError(f"pad2d mode {mode!r} takes a floating tensor")
    return F.pad(xn, (left, right, top, bottom), mode=torch_mode).permute(0, 2, 3, 1)


def resize_nearest(x, out_shape: Tuple[int, int]):
    """Nearest resize, NHWC: output row i reads input row i * H // OH (the
    JAX package's formula)."""
    n, h, w, c = x.shape
    oh, ow = out_shape
    rows = torch.arange(oh, device=x.device) * h // oh
    cols = torch.arange(ow, device=x.device) * w // ow
    return x[:, rows][:, :, cols]


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """``jax.image.resize``'s bilinear weight matrix [out, in] in f32: the
    triangle kernel at half-pixel centres, widened by in/out when shrinking
    (the antialiasing filter), each row normalised to sum 1 and zero where
    the sample falls outside the input (``jax._src.image.scale
    .compute_weight_mat``)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    pos = torch.arange(in_size, dtype=torch.float32, device=device)
    # constants of the shapes: nothing here is differentiated
    w = torch.clamp_min(1 - torch.abs(sample[:, None] - pos[None, :]) / kernel_scale, 0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], w, 0.0)


def resize_bilinear(x, out_shape: Tuple[int, int], align_corners: bool = False):
    """Bilinear resize, NHWC. ``align_corners=False`` is
    ``jax.image.resize(method="bilinear")``: half-pixel centres and, when a
    side shrinks, the antialiasing triangle filter (``F.interpolate`` with
    ``antialias=False`` does not filter). It contracts each changed side
    with :func:`_resize_weights` as an f32 product (full f32 on the card).
    ``align_corners=True`` (the fluid default) maps the corner pixels
    exactly: sample positions i * (in - 1) / (out - 1), in f32."""
    n, h, w, c = x.shape
    oh, ow = out_shape
    if not align_corners:
        out = x if x.is_floating_point() else x.float()
        if oh != h:
            wh = _resize_weights(h, oh, x.device)
            out = f32_product(wh, out.reshape(n, h, w * c)).reshape(n, oh, w, c).to(out.dtype)
        if ow != w:
            ww = _resize_weights(w, ow, x.device)
            out = f32_product(ww, out.reshape(n * oh, w, c)).reshape(n, oh, ow, c).to(out.dtype)
        return out

    def coords(out_size, in_size):
        if out_size == 1:
            return torch.zeros((1,), dtype=torch.float32, device=x.device)
        return torch.arange(out_size, dtype=torch.float32, device=x.device) * (
            (in_size - 1) / (out_size - 1))

    ys, xs = coords(oh, h), coords(ow, w)
    # integer indices: no gradient reaches them
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0.float())[None, :, None, None]
    wx = (xs - x0.float())[None, None, :, None]
    xf = x.float()
    top = xf[:, y0][:, :, x0] * (1 - wx) + xf[:, y0][:, :, x1] * wx
    bot = xf[:, y1][:, :, x0] * (1 - wx) + xf[:, y1][:, :, x1] * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)


def matmul_bias(x, w, b=None):
    """``x @ w (+ b)``: operands in the compute dtype, f32 accumulation,
    result in x's dtype."""
    out = f32_product(*mxu_operands(x, w)).to(x.dtype)
    return out + b if b is not None else out


def multiplex(inputs: Sequence[torch.Tensor], index: torch.Tensor) -> torch.Tensor:
    """Row-wise select among N same-shaped inputs (reference
    ``multiplex_op.cc``): out[b] = inputs[index[b]][b]."""
    stacked = torch.stack(list(inputs), dim=0)  # [N, B, ...]
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=stacked.device)]


def row_conv(x: torch.Tensor, weight: torch.Tensor, lengths: Optional[torch.Tensor] = None):
    """Lookahead row convolution (reference ``row_conv_op.cc``, DeepSpeech2):
    out[b, t, d] = Σ_k w[k, d] · x[b, t+k, d] over the ``weight.shape[0]``
    future steps, in f32; steps past a row's length read and give 0."""
    b, t, d = x.shape
    mask = None
    if lengths is not None:
        mask = (torch.arange(t, device=x.device)[None, :] < lengths.to(x.device)[:, None])[..., None]
        x = torch.where(mask, x, 0.0)
    out = torch.zeros((b, t, d), dtype=torch.float32, device=x.device)
    for k in range(weight.shape[0]):
        shifted = F.pad(x[:, k:], (0, 0, 0, k))
        out = out + shifted.float() * weight[k].float()
    out = out.to(x.dtype)
    return torch.where(mask, out, 0.0) if mask is not None else out


def pad_constant_like(x: torch.Tensor, y: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
    """Pad ``y`` at the tail of every axis to ``x``'s shape (reference
    ``pad_constant_like_op.cc``)."""
    flat = []
    for xs, ys in zip(reversed(x.shape), reversed(y.shape)):
        flat += [0, int(xs - ys)]
    return F.pad(y, flat, value=pad_value)


def rank_loss(label: torch.Tensor, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """RankNet pairwise loss (reference ``rank_loss_op.cc``):
    log(1 + e^o) - label * o with o = left - right, computed stably."""
    o = (left - right).float()
    return (torch.logaddexp(torch.zeros_like(o), o) - label.float() * o).to(left.dtype)


def dice_loss(input: torch.Tensor, label: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Dice loss over per-row probability maps (reference fluid
    ``layers.dice_loss``): 1 - 2|X∩Y| / (|X|+|Y|), averaged over rows."""
    p = input.float().reshape(input.shape[0], -1)
    g = label.float().reshape(label.shape[0], -1)
    inter = torch.sum(p * g, dim=1)
    union = torch.sum(p, dim=1) + torch.sum(g, dim=1)
    return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


def mean_iou(pred: torch.Tensor, label: torch.Tensor, num_classes: int):
    """Mean intersection-over-union (reference ``mean_iou_op.cc``):
    ``(mean_iou f32 scalar, per-class wrong int32, per-class correct
    int32)``, the mean over the classes present in pred or label."""
    p = pred.reshape(-1).long()
    lab = label.reshape(-1).long()

    def count(ids):
        return torch.bincount(ids, minlength=num_classes)[:num_classes].to(torch.int32)

    correct = count(lab[p == lab])
    union = count(p) + count(lab) - correct
    wrong = union - correct
    present = union > 0
    # integer counts: not differentiated
    iou = torch.where(present, correct / torch.clamp_min(union, 1), 0.0)
    miou = torch.sum(iou) / torch.clamp_min(torch.sum(present.to(torch.int32)), 1)
    return miou.float(), wrong, correct


def nce_loss(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    labels: torch.Tensor,
    num_neg_samples: int,
    rng: Optional[torch.Generator],
    num_total_classes: Optional[int] = None,
    samples: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Noise-contrastive estimation loss (reference ``nce_op.cc``): binary
    logistic discrimination of the true class against ``num_neg_samples``
    uniformly drawn noise classes. ``weight`` [num_classes, D], ``x`` [B, D],
    ``labels`` [B]. Returns per-row loss [B]. Only the (1 + S) rows of the
    class matrix each example needs are gathered.

    The noise ids are ``samples`` [B, S] when given, else drawn uniformly
    from ``rng`` (a ``torch.Generator``; the JAX package's PRNG key), on the
    generator's device: sampling is apart from the loss, so a test can give
    the JAX package's draws to both."""
    n_classes = num_total_classes or weight.shape[0]
    b = x.shape[0]
    if samples is None:
        samples = torch.randint(0, n_classes, (b, num_neg_samples), generator=rng,
                                device=rng.device)
    ids = torch.cat([labels.reshape(b, 1).long(), samples.to(x.device).long()], dim=1)
    w = weight[ids]  # [B, 1+S, D]
    logits = f32_product(w.float(), x.float()[:, :, None])[..., 0]
    if bias is not None:
        logits = logits + bias[ids].float()
    # NCE posterior correction: classify against k noise samples from the
    # uniform prior q = 1/num_classes, i.e. with logit - log(k*q)
    logits = logits - _math.log(num_neg_samples / n_classes)
    labels01 = torch.zeros_like(logits)
    labels01[:, 0] = 1.0
    per = (om.maximum(logits, 0.0) - logits * labels01
           + torch.logaddexp(torch.zeros_like(logits), -om.abs(logits)))
    return torch.sum(per, dim=1)


def hsigmoid_loss(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    labels: torch.Tensor,
    num_classes: int,
) -> torch.Tensor:
    """Hierarchical sigmoid loss over the default complete binary tree
    (reference ``hierarchical_sigmoid_op.cc`` with MatrixBitCode): class c's
    leaf sits at heap id c + num_classes; the path to the root visits
    internal nodes id//2 with the branch bit id&1. ``weight`` is
    [num_classes - 1, D] (one row per internal node). Returns per-row loss
    [B]."""
    code_len = max(1, (max(num_classes, 2) - 1).bit_length())
    node = labels.long() + num_classes  # heap ids, root = 1
    total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    xf = x.float()
    for _ in range(code_len):
        bit = (node & 1).float()  # branch taken at the parent
        parent = node // 2
        idx = torch.clamp(parent - 1, 0, num_classes - 2)  # an integer index
        active = (parent >= 1).float()
        logit = torch.sum(xf * weight[idx].float(), dim=-1)
        if bias is not None:
            logit = logit + bias[idx].float()
        per = (om.maximum(logit, 0.0) - logit * bit
               + torch.logaddexp(torch.zeros_like(logit), -om.abs(logit)))
        total = total + per * active
        node = parent
    return total

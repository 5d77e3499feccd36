"""Neural-network ops — the subset of ``paddle_tpu.ops.nn`` the ported slices
use: conv, pooling and adaptive pooling, batch norm, softmax and losses,
accuracy, layer norm, embedding lookup, dropout, one-hot and label
smoothing.

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

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import compute_dtype, ieee_f32
from paddle_tpu_torch.parallel import context as dp_context

__all__ = [
    "conv2d", "pool2d", "softmax", "cross_entropy", "softmax_with_cross_entropy",
    "square_error_cost", "accuracy", "layer_norm", "embedding_lookup", "dropout",
    "adaptive_pool2d", "batch_norm_train", "batch_norm_infer", "one_hot", "label_smooth",
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
    """An f32 convolution on CUDA whose forward and backward both run under
    :func:`~paddle_tpu_torch.core.dtypes.ieee_f32`: cuDNN reads its TF32
    switch when each kernel runs, and autograd runs the backward after any
    ``with`` around the forward has exited."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        with ieee_f32():
            return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with ieee_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, False, [0, 0], groups, mask)
        return dx, dw, None, None, None, None


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: _IntOrPair = 1,
    padding: Union[str, _IntOrPair] = 0,
    dilation: _IntOrPair = 1,
    groups: int = 1,
) -> torch.Tensor:
    """2-D convolution, NHWC activations × HWIO weights (reference
    ``operators/conv_op.cc``): ``F.conv2d`` on the operands in the compute
    dtype (bf16 under ``use_bf16_compute``), result in x's dtype. f32
    operands on CUDA convolve in full f32, forward and backward
    (:class:`_F32Conv`; the rule is in :mod:`paddle_tpu_torch.core.dtypes`).

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
    conf = ((sh, sw), pad, (dh, dw), groups)
    if xn.is_cuda and xn.dtype == torch.float32:
        out = _F32Conv.apply(xn, wn, *conf)
    else:
        out = F.conv2d(xn, wn, None, *conf)
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
    logp = torch.log(torch.clamp_min(probs.float(), 1e-10))
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

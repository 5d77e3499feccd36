"""Image/vision ops: resize dispatch, random crop, ROI pooling, im2sequence —
port of ``paddle_tpu/ops/vision.py``.

Reference: ``operators/interpolate`` family (``bilinear_interp_op.cc``,
``nearest_interp_op.cc`` behind fluid ``layers.image_resize``),
``operators/random_crop_op.cc``, ``operators/roi_pool_op.cc``,
``operators/im2sequence_op.cc``. All NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.nn import resize_bilinear, resize_nearest

__all__ = [
    "image_resize",
    "image_resize_short",
    "random_crop",
    "roi_pool",
    "im2sequence",
]


def image_resize(
    x: torch.Tensor,
    out_shape: Optional[Sequence[int]] = None,
    scale: Optional[float] = None,
    resample: str = "BILINEAR",
    align_corners: bool = True,
) -> torch.Tensor:
    """fluid ``layers.image_resize`` dispatch (reference ``layers/nn.py``
    image_resize → bilinear/nearest interp ops)."""
    n, h, w, c = x.shape
    if out_shape is None:
        if scale is None:
            raise ValueError("one of out_shape / scale is required")
        out_shape = (int(h * scale), int(w * scale))
    oh, ow = int(out_shape[0]), int(out_shape[1])
    method = resample.upper()
    if method == "BILINEAR":
        return resize_bilinear(x, (oh, ow), align_corners=align_corners)
    if method == "NEAREST":
        return resize_nearest(x, (oh, ow))
    raise ValueError(f"resample must be BILINEAR or NEAREST, got {resample!r}")


def image_resize_short(x: torch.Tensor, out_short_len: int, resample: str = "BILINEAR"):
    """Resize so the shorter edge becomes ``out_short_len``, preserving
    aspect ratio (reference ``layers/nn.py`` image_resize_short)."""
    n, h, w, c = x.shape
    short, long_ = (h, w) if h < w else (w, h)
    new_long = int(round(long_ * out_short_len / short))
    out_shape = (out_short_len, new_long) if h < w else (new_long, out_short_len)
    return image_resize(x, out_shape=out_shape, resample=resample)


def random_crop(x: torch.Tensor, crop_shape: Tuple[int, int], rng: torch.Generator) -> torch.Tensor:
    """Per-sample random spatial crop of an NHWC batch (reference
    ``random_crop_op.cc``): independent offsets per row, drawn uniformly
    from ``rng`` (a ``torch.Generator``, on its device; the JAX package's
    PRNG key)."""
    n, h, w, c = x.shape
    ch, cw = crop_shape
    ys = torch.randint(0, h - ch + 1, (n,), generator=rng, device=rng.device).to(x.device)
    xs = torch.randint(0, w - cw + 1, (n,), generator=rng, device=rng.device).to(x.device)
    rows = ys[:, None] + torch.arange(ch, device=x.device)  # [N, ch]
    cols = xs[:, None] + torch.arange(cw, device=x.device)  # [N, cw]
    return x[torch.arange(n, device=x.device)[:, None, None], rows[:, :, None], cols[:, None, :]]


def roi_pool(
    x: torch.Tensor,
    rois: torch.Tensor,
    roi_batch_idx: torch.Tensor,
    pooled_height: int,
    pooled_width: int,
    spatial_scale: float = 1.0,
) -> torch.Tensor:
    """Max-pool each region of interest into a fixed grid (reference
    ``roi_pool_op.cc``, Fast R-CNN). ``rois`` [R, 4] are (x1, y1, x2, y2) in
    input-image coordinates; ``roi_batch_idx`` [R] maps each ROI to its
    batch row. Returns [R, pooled_h, pooled_w, C]. As in the JAX package,
    each ROI builds separable bin-membership masks over H and W and
    max-reduces (over W per output column, then over H per output row);
    empty bins pool to 0."""
    n, h, w, c = x.shape
    dev = x.device
    feats = x[roi_batch_idx.long().to(dev)]  # [R, H, W, C]
    r = rois.float().to(dev) * spatial_scale
    x1, y1, x2, y2 = (torch.round(r[:, i]) for i in range(4))
    # the boxes are rounded and the bins floored: no gradient reaches them
    bin_h = torch.clamp_min(y2 - y1 + 1.0, 1.0) / pooled_height  # [R]
    bin_w = torch.clamp_min(x2 - x1 + 1.0, 1.0) / pooled_width

    ph = torch.arange(pooled_height, dtype=torch.float32, device=dev)
    pw = torch.arange(pooled_width, dtype=torch.float32, device=dev)
    # bin edges, clipped to the feature map (reference hstart/hend math)
    hstart = torch.clamp(torch.floor(ph[None, :] * bin_h[:, None]) + y1[:, None], 0, h)
    hend = torch.clamp(torch.ceil((ph[None, :] + 1) * bin_h[:, None]) + y1[:, None], 0, h)
    wstart = torch.clamp(torch.floor(pw[None, :] * bin_w[:, None]) + x1[:, None], 0, w)
    wend = torch.clamp(torch.ceil((pw[None, :] + 1) * bin_w[:, None]) + x1[:, None], 0, w)

    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    my = (ys[None, None, :] >= hstart[:, :, None]) & (ys[None, None, :] < hend[:, :, None])
    mx = (xs[None, None, :] >= wstart[:, :, None]) & (xs[None, None, :] < wend[:, :, None])

    neg = torch.finfo(torch.float32).min
    f = feats.float()
    fx = torch.where(mx[:, None, :, :, None], f[:, :, None, :, :], neg).amax(dim=3)  # [R,H,PW,C]
    out = torch.where(my[:, :, :, None, None], fx[:, None, :, :, :], neg).amax(dim=2)
    empty = (hstart >= hend)[:, :, None, None] | (wstart >= wend)[:, None, :, None]
    return torch.where(empty, 0.0, out).to(x.dtype)


def im2sequence(
    x: torch.Tensor,
    filter_size: Union[int, Tuple[int, int]] = 1,
    stride: Union[int, Tuple[int, int]] = 1,
    padding: Union[int, Tuple[int, int]] = 0,
) -> torch.Tensor:
    """Unfold image patches into a sequence (reference
    ``im2sequence_op.cc``): NHWC [B, H, W, C] → [B, OH*OW, C*FH*FW], each
    output step one flattened patch, channel-major as
    ``lax.conv_general_dilated_patches`` orders it (``F.unfold``'s order)."""
    fh, fw = (filter_size, filter_size) if isinstance(filter_size, int) else filter_size
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    cols = F.unfold(x.permute(0, 3, 1, 2), (fh, fw), stride=(sh, sw), padding=(ph, pw))
    return cols.transpose(1, 2)

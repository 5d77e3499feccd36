"""RPN / Faster-R-CNN detection ops and the EAST geometry transforms — port
of ``paddle_tpu/ops/detection_rpn.py``, name for name.

Reference: ``paddle/fluid/operators/detection/rpn_target_assign_op.cc``,
``generate_proposals_op.cc``, ``generate_proposal_labels_op.cc``,
``roi_perspective_transform_op.cc``, ``polygon_box_transform_op.cc``.

Fixed-shape programs, as in the JAX package: subsampling takes the top-k of
random priorities instead of shuffling, proposal lists are padded to
``post_nms_top_n`` with validity counts, and the perspective warp solves
the 4-point homography of every RoI at once (``torch.linalg.solve``, f32).

Randomness: the samplers draw their priorities (uniform in [0, 1), one
vector for the foreground and one for the background) from ``rng``, a
``torch.Generator``, on its device; ``uniforms=`` [2, n] gives them
instead, so a test can give both packages the JAX package's draws; with
neither, they come from the running apply's generator. The
selection from given priorities is exact: top-k and the background's rank
rank equal priorities lower index first (a stable sort), as ``lax.top_k``
and ``jnp.argsort`` do. The streams are the port's own: they agree with
JAX's in distribution, not value by value. Labels are int32, as the JAX
package names them; see :mod:`.detection` for the rest of the conventions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.core.dtypes import NEG_INF
from paddle_tpu_torch.ops import math as om
from paddle_tpu_torch.ops.detection import box_clip, box_coder, iou_similarity, nms

__all__ = [
    "rpn_target_assign",
    "generate_proposals",
    "generate_proposal_labels",
    "roi_perspective_transform",
    "polygon_box_transform",
]


def _uniforms(rng: Optional[torch.Generator], uniforms: Optional[torch.Tensor], n: int,
              device) -> torch.Tensor:
    """The samplers' priorities [2, n]: ``uniforms`` when given, else drawn
    from ``rng`` on its device (by default the running apply's generator,
    as the port's other random ops draw)."""
    if uniforms is None:
        g = om._generator(rng)
        uniforms = torch.rand(2, n, generator=g, device=g.device)
    return uniforms.to(device=device, dtype=torch.float32)


def _sample_topk(eligible: torch.Tensor, k: int, u: torch.Tensor) -> torch.Tensor:
    """Up to ``k`` of the eligible entries: the top-k of the priorities
    ``u`` (-1 where not eligible), a fixed-shape program (the reference's
    ReservoirSampling / random_shuffle loops)."""
    n = eligible.shape[0]
    pri = torch.where(eligible, u, -1.0)
    _, idx = om.topk(pri, min(k, n))
    chosen = torch.zeros(n, dtype=torch.bool, device=eligible.device).index_fill(0, idx, True)
    return chosen & eligible


def _fill_by_rank(eligible: torch.Tensor, u: torch.Tensor, room: torch.Tensor) -> torch.Tensor:
    """The eligible entries whose priority ranks below ``room`` (a tensor:
    no host sync), in a stable descending order of the priorities."""
    n = eligible.shape[0]
    order = torch.sort(-torch.where(eligible, u, -1.0), stable=True).indices
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=order.device))
    return eligible & (rank < room)


def _cwh(box):
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    return box[..., 0] + w / 2, box[..., 1] + h / 2, w, h


def _encode(boxes: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Each box's matched gt as center-size offsets against the box (unit
    variances; the diagonal of box_coder's N×M encode)."""
    cx, cy, w, h = _cwh(boxes)
    gcx, gcy, gw, gh = _cwh(gt)
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's (here and below)
    w_, h_ = w.clamp_min(1e-6), h.clamp_min(1e-6)
    return torch.stack([
        (gcx - cx) / w_,
        (gcy - cy) / h_,
        torch.log(gw.clamp_min(1e-6) / w_),
        torch.log(gh.clamp_min(1e-6) / h_),
    ], dim=-1)


def rpn_target_assign(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    rng: Optional[torch.Generator] = None,
    rpn_batch_size_per_im: int = 256,
    fg_fraction: float = 0.5,
    rpn_positive_overlap: float = 0.7,
    rpn_negative_overlap: float = 0.3,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assign RPN training targets (reference ``rpn_target_assign_op.cc``):
    fg = anchors with IoU >= positive_overlap with any gt, plus the best
    anchor of each valid gt; bg = IoU < negative_overlap; subsample to
    ``rpn_batch_size_per_im`` at ``fg_fraction``. Fixed-shape outputs:

    returns (labels [A] int32 {1 fg, 0 bg, -1 ignore},
             bbox_targets [A, 4] encoded vs anchors,
             loc_weight [A] 1.0 on fg,
             score_weight [A] 1.0 on sampled fg+bg).

    ``gt_boxes`` [G, 4] padded, ``gt_valid`` [G] bool. Where several gts
    name one anchor as their best (a padded gt's row is all zero, so it
    names anchor 0), the last of them decides, as the JAX package's scatter
    applies its updates in order: a valid gt makes the anchor fg, a padded
    one leaves it as the overlap rule set it."""
    a = anchors.shape[0]
    iou = iou_similarity(gt_boxes, anchors)  # [G, A]
    iou = torch.where(gt_valid[:, None], iou, 0.0)
    anchor_best, anchor_gt = torch.max(iou, dim=0)  # [A]
    fg = anchor_best >= rpn_positive_overlap
    # the best anchor of each valid gt is fg (the reference's second rule)
    best_per_gt = torch.argmax(iou, dim=1)  # [G]
    gts = torch.arange(gt_boxes.shape[0], device=iou.device)
    last = torch.full((a,), -1, dtype=torch.long, device=iou.device).scatter_reduce(
        0, best_per_gt, gts, "amax")
    fg = torch.where(last >= 0, gt_valid[last.clamp_min(0)] | fg, fg)
    bg = (anchor_best < rpn_negative_overlap) & ~fg

    u = _uniforms(rng, uniforms, a, anchors.device)
    fg_sel = _sample_topk(fg, int(rpn_batch_size_per_im * fg_fraction), u[0])
    bg_sel = _fill_by_rank(bg, u[1], rpn_batch_size_per_im - fg_sel.sum(dtype=torch.int32))
    labels = torch.where(fg_sel, 1, torch.where(bg_sel, 0, -1)).to(torch.int32)
    bbox_targets = _encode(anchors, gt_boxes[anchor_gt])
    return labels, bbox_targets, fg_sel.float(), (fg_sel | bg_sel).float()


def generate_proposals(
    scores: torch.Tensor,
    bbox_deltas: torch.Tensor,
    anchors: torch.Tensor,
    variances: torch.Tensor,
    image_shape: Tuple[float, float],
    pre_nms_top_n: int = 6000,
    post_nms_top_n: int = 1000,
    nms_thresh: float = 0.5,
    min_size: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode RPN outputs into proposals (reference
    ``generate_proposals_op.cc`` ProposalForOneImage): decode deltas against
    anchors, clip to the image, drop boxes smaller than min_size, keep
    ``pre_nms_top_n`` by score (equal scores lower index first), NMS, keep
    ``post_nms_top_n``.

    scores [A], bbox_deltas [A, 4], anchors/variances [A, 4]. Returns
    (proposals [post_nms_top_n, 4], proposal_scores [post_nms_top_n],
    count); padding rows are 0 with score NEG_INF."""
    boxes = box_clip(box_coder(anchors, variances, bbox_deltas, "decode_center_size"), image_shape)
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    s = torch.where((w >= min_size) & (h >= min_size), scores, NEG_INF)
    k = min(pre_nms_top_n, s.shape[0])
    top_s, top_i = om.topk(s, k)
    top_boxes = boxes[top_i]
    sel, count = nms(top_boxes, top_s, min(post_nms_top_n, k), nms_thresh,
                     score_threshold=NEG_INF / 2)
    valid = sel >= 0
    safe = sel.clamp_min(0).long()  # an index: not differentiated
    props = torch.where(valid[:, None], top_boxes[safe], 0.0)
    pscores = torch.where(valid, top_s[safe], NEG_INF)
    pad = post_nms_top_n - props.shape[0]
    if pad > 0:
        props = torch.cat([props, props.new_zeros(pad, 4)])
        pscores = torch.cat([pscores, pscores.new_full((pad,), NEG_INF)])
    return props, pscores, count


def generate_proposal_labels(
    rois: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    rng: Optional[torch.Generator] = None,
    batch_size_per_im: int = 256,
    fg_fraction: float = 0.25,
    fg_thresh: float = 0.5,
    bg_thresh_hi: float = 0.5,
    bg_thresh_lo: float = 0.0,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample RoIs and assign Fast-R-CNN head targets (reference
    ``generate_proposal_labels_op.cc``): fg RoIs have max-IoU >= fg_thresh
    (sampled to fg_fraction of the batch), bg RoIs fall in
    [bg_thresh_lo, bg_thresh_hi). Fixed-shape outputs over all R rois:

    returns (labels [R] int32 {class, 0 bg, -1 unsampled},
             bbox_targets [R, 4] encoded vs roi,
             loc_weight [R], sample_weight [R])."""
    r = rois.shape[0]
    iou = iou_similarity(gt_boxes, rois)  # [G, R]
    iou = torch.where(gt_valid[:, None], iou, 0.0)
    best, best_gt = torch.max(iou, dim=0)
    fg = best >= fg_thresh
    bg = (best < bg_thresh_hi) & (best >= bg_thresh_lo) & ~fg
    u = _uniforms(rng, uniforms, r, rois.device)
    fg_sel = _sample_topk(fg, int(batch_size_per_im * fg_fraction), u[0])
    bg_sel = _fill_by_rank(bg, u[1], batch_size_per_im - fg_sel.sum(dtype=torch.int32))
    cls = gt_labels.to(torch.int32)[best_gt]
    labels = torch.where(fg_sel, cls, torch.where(bg_sel, 0, -1)).to(torch.int32)
    bbox_targets = _encode(rois, gt_boxes[best_gt])
    return labels, bbox_targets, fg_sel.float(), (fg_sel | bg_sel).float()


def roi_perspective_transform(
    x: torch.Tensor,
    rois: torch.Tensor,
    transformed_height: int,
    transformed_width: int,
    spatial_scale: float = 1.0,
) -> torch.Tensor:
    """Warp quadrilateral RoIs to fixed rectangles (reference
    ``roi_perspective_transform_op.cc``, EAST OCR): each RoI is 8 coords
    (x1..y4, clockwise from top-left). Solves every RoI's 4-point
    homography at once (a batched 8×8 ``torch.linalg.solve`` in f32) and
    samples the NHWC feature map bilinearly; samples outside the map are
    0. rois: [R, 8] on image 0 (pass x gathered per RoI otherwise).
    Returns [R, th, tw, C]."""
    n, h, w, c = x.shape
    dev = x.device
    quad = rois.reshape(-1, 4, 2).float() * spatial_scale  # [R, 4, (x, y)]
    th, tw = transformed_height, transformed_width
    # destination corners (clockwise from top-left), in output coords; the
    # homography maps them to the source so that sampling is a gather
    dst = [(0.0, 0.0), (tw - 1.0, 0.0), (tw - 1.0, th - 1.0), (0.0, th - 1.0)]
    zero, one = quad.new_zeros(quad.shape[0]), quad.new_ones(quad.shape[0])
    rows = []
    for i, (dx, dy) in enumerate(dst):
        sx, sy = quad[:, i, 0], quad[:, i, 1]
        rows.append(torch.stack([zero + dx, zero + dy, one, zero, zero, zero, -dx * sx, -dy * sx], -1))
        rows.append(torch.stack([zero, zero, zero, zero + dx, zero + dy, one, -dx * sy, -dy * sy], -1))
    A = torch.stack(rows, dim=1)  # [R, 8, 8]
    hvec = torch.linalg.solve(A, quad.reshape(-1, 8))  # b = [sx1, sy1, sx2, sy2, ...]
    H = torch.cat([hvec, one[:, None]], dim=1).reshape(-1, 3, 3)  # [R, 3, 3]

    gy, gx = torch.meshgrid(torch.arange(th, dtype=torch.float32, device=dev),
                            torch.arange(tw, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)  # [P, 3]
    src = torch.einsum("pk,rjk->rpj", grid, H)  # [R, P, 3]
    z = src[..., 2]
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's
    denom = om.abs(z).clamp_min(1e-8)
    sx = src[..., 0] / denom * torch.sign(z)  # sign(0) = 0, as jnp.sign
    sy = src[..., 1] / denom * torch.sign(z)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    # indices: truncated after the floor (astype(int32)), then clamped
    x0i = x0.to(torch.int32).clamp(0, w - 1).long()
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.to(torch.int32).clamp(0, h - 1).long()
    y1i = (y0i + 1).clamp(0, h - 1)
    img = x[0]  # [H, W, C]
    top = img[y0i, x0i] * (1 - fx) + img[y0i, x1i] * fx
    bot = img[y1i, x0i] * (1 - fx) + img[y1i, x1i] * fx
    out = top * (1 - fy) + bot * fy
    oob = (sx < 0) | (sx > w - 1) | (sy < 0) | (sy > h - 1)
    return torch.where(oob[..., None], 0.0, out).reshape(-1, th, tw, c).to(x.dtype)


def polygon_box_transform(x: torch.Tensor) -> torch.Tensor:
    """EAST geometry-map transform (reference
    ``polygon_box_transform_op.cc``): input [B, G, H, W]; even geometry
    channels hold x-offsets (out = col_index - in), odd channels y-offsets
    (out = row_index - in)."""
    b, g, h, w = x.shape
    cols = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    rows = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    even = (torch.arange(g, device=x.device) % 2 == 0)[None, :, None, None]
    return torch.where(even, cols - x, rows - x)

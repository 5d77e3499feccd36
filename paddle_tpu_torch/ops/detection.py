"""Detection-model ops (SSD/RPN family) — port of
``paddle_tpu/ops/detection.py``, name for name.

Reference: ``paddle/fluid/operators/detection/`` — prior_box_op, anchor_
generator_op, box_coder_op, iou_similarity_op, bipartite_match_op,
multiclass_nms_op, target_assign_op. As in the JAX package the outputs have
fixed shapes: matching and NMS are bounded iterative selections that emit
padded outputs and validity counts instead of LoD-sized results.

Boxes are [x_min, y_min, x_max, y_max], matching the reference's layout
(``bbox_util.h``).

How the JAX package's semantics are kept:

- every ``jnp.maximum``/``jnp.minimum``/``jnp.clip``/``jnp.abs`` of a
  differentiated value is :mod:`.math`'s (ties split the gradient, |x| has
  gradient 1 at 0), bar the eps floors, which no value ties (``clamp_min``);
- the ``lax.fori_loop`` selections (:func:`bipartite_match`, :func:`nms`,
  :func:`detection_map`) are loops issued from the host with a fixed trip
  count and no host sync: no ``.item()``, no branch on a tensor; each step
  masks with ``torch.where`` as the JAX body does. :func:`nms` runs over a
  leading class axis, so :func:`multiclass_nms` is one loop of
  ``nms_top_k`` steps on [C-1, N] masks (the JAX package's ``vmap``), with
  the IoU matrix built once;
- ``lax.top_k`` and ``jnp.argsort`` rank equal values lower index first
  (:func:`.math.topk`, ``torch.sort(stable=True)``); ``argmax`` takes the
  first maximum, as ``torch.argmax`` does;
- match indices, selections, counts and labels are int32, as the JAX
  package names them; the padding and masking sentinel is the finite
  :data:`~paddle_tpu_torch.core.dtypes.NEG_INF`;
- :func:`ssd_loss`, :func:`detection_output` and :func:`detection_map`
  take one image, as in the JAX package: a batch is a loop over images.

Creation ops (:func:`prior_box`, :func:`anchor_generator`) take ``device=``
(default: the running ``Model.init``/``apply``'s device, else CUDA). Plain
PyTorch: the JAX package leaves these to XLA, so no kernel is owed.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from paddle_tpu_torch.core.dtypes import NEG_INF
from paddle_tpu_torch.ops import math as om

__all__ = [
    "prior_box",
    "anchor_generator",
    "box_coder",
    "iou_similarity",
    "bipartite_match",
    "nms",
    "multiclass_nms",
    "target_assign",
    "box_clip",
    "detection_output",
    "ssd_loss",
    "detection_map",
]


def _consts(values, dev) -> torch.Tensor:
    """A short list of Python floats as an f32 tensor on ``dev``: staged
    from the host without waiting for the device's queue."""
    return torch.tensor(values, dtype=torch.float32).to(dev, non_blocking=True)


def prior_box(
    feature_shape: Tuple[int, int],
    image_shape: Tuple[int, int],
    min_sizes: Sequence[float],
    max_sizes: Sequence[float] = (),
    aspect_ratios: Sequence[float] = (1.0,),
    variance: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
    flip: bool = False,
    clip: bool = False,
    step: Tuple[float, float] = (0.0, 0.0),
    offset: float = 0.5,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD prior boxes (reference ``prior_box_op.h:46-150``): per feature-map
    cell one box per (min_size × aspect_ratio) plus one per max_size
    (geometric mean size). Returns (boxes [H, W, P, 4], variances same
    shape)."""
    dev = om._device(device)
    H, W = feature_shape
    img_h, img_w = image_shape
    step_h = step[0] or img_h / H
    step_w = step[1] or img_w / W

    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))

    widths, heights = [], []
    for ms in min_sizes:
        for ar in ars:
            widths.append(ms * (ar ** 0.5))
            heights.append(ms / (ar ** 0.5))
    for ms, mx in zip(min_sizes, max_sizes):
        s = (ms * mx) ** 0.5
        widths.append(s)
        heights.append(s)
    P = len(widths)
    f32 = dict(dtype=torch.float32, device=dev)
    w_half = _consts(widths, dev) / (2.0 * img_w)  # [P]
    h_half = _consts(heights, dev) / (2.0 * img_h)

    cx = ((torch.arange(W, **f32) + offset) * step_w) / img_w  # [W]
    cy = ((torch.arange(H, **f32) + offset) * step_h) / img_h  # [H]
    cx = cx[None, :, None].expand(H, W, P)
    cy = cy[:, None, None].expand(H, W, P)
    boxes = torch.stack([cx - w_half, cy - h_half, cx + w_half, cy + h_half], dim=-1)
    if clip:
        boxes = om.clip(boxes, 0.0, 1.0)
    variances = _consts(variance, dev).expand(boxes.shape)
    return boxes, variances


def anchor_generator(
    feature_shape: Tuple[int, int],
    anchor_sizes: Sequence[float] = (64.0, 128.0, 256.0, 512.0),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
    variance: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
    stride: Tuple[float, float] = (16.0, 16.0),
    offset: float = 0.5,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RPN anchors in input-image coordinates (reference
    ``anchor_generator_op.h``): per cell, |sizes|×|ratios| anchors. Returns
    (anchors [H, W, A, 4], variances same shape)."""
    dev = om._device(device)
    H, W = feature_shape
    ws, hs = [], []
    for ar in aspect_ratios:
        for size in anchor_sizes:
            w = (size * size / ar) ** 0.5
            ws.append(w)
            hs.append(w * ar)
    A = len(ws)
    f32 = dict(dtype=torch.float32, device=dev)
    w_half = _consts(ws, dev) / 2.0
    h_half = _consts(hs, dev) / 2.0
    cx = ((torch.arange(W, **f32) + offset) * stride[0])[None, :, None].expand(H, W, A)
    cy = ((torch.arange(H, **f32) + offset) * stride[1])[:, None, None].expand(H, W, A)
    anchors = torch.stack([cx - w_half, cy - h_half, cx + w_half, cy + h_half], dim=-1)
    variances = _consts(variance, dev).expand(anchors.shape)
    return anchors, variances


def _box_to_cwh(box):
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    return box[..., 0] + w / 2.0, box[..., 1] + h / 2.0, w, h


def box_coder(
    prior_boxes: torch.Tensor,
    prior_variances: torch.Tensor,
    target_or_codes: torch.Tensor,
    code_type: str = "encode_center_size",
) -> torch.Tensor:
    """Encode boxes to center-size offsets against priors, or decode offsets
    back (reference ``box_coder_op.h`` EncodeCenterSize/DecodeCenterSize).

    encode: priors [M, 4], targets [N, 4] → codes [N, M, 4]
    decode: priors [M, 4], codes [N, M, 4] (or [M, 4]) → boxes same shape
    """
    pcx, pcy, pw, ph = _box_to_cwh(prior_boxes)
    var = prior_variances
    if code_type == "encode_center_size":
        tcx, tcy, tw, th = (v[:, None] for v in _box_to_cwh(target_or_codes))
        return torch.stack([
            (tcx - pcx[None, :]) / pw[None, :] / var[None, :, 0],
            (tcy - pcy[None, :]) / ph[None, :] / var[None, :, 1],
            torch.log(tw / pw[None, :]) / var[None, :, 2],
            torch.log(th / ph[None, :]) / var[None, :, 3],
        ], dim=-1)
    if code_type == "decode_center_size":
        c = target_or_codes
        cx = c[..., 0] * var[..., 0] * pw + pcx
        cy = c[..., 1] * var[..., 1] * ph + pcy
        w = torch.exp(c[..., 2] * var[..., 2]) * pw
        h = torch.exp(c[..., 3] * var[..., 3]) * ph
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    raise ValueError(f"unknown code_type {code_type!r}")


def iou_similarity(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (reference ``iou_similarity_op.h``): x [N, 4], y [M, 4]
    → [N, M]; 0 where the union is empty (zero-width boxes)."""
    def area(b):
        return om.maximum(b[..., 2] - b[..., 0], 0.0) * om.maximum(b[..., 3] - b[..., 1], 0.0)

    xl = om.maximum(x[:, None, 0], y[None, :, 0])
    yt = om.maximum(x[:, None, 1], y[None, :, 1])
    xr = om.minimum(x[:, None, 2], y[None, :, 2])
    yb = om.minimum(x[:, None, 3], y[None, :, 3])
    inter = om.maximum(xr - xl, 0.0) * om.maximum(yb - yt, 0.0)
    union = area(x)[:, None] + area(y)[None, :] - inter
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's
    return torch.where(union > 0, inter / union.clamp_min(1e-10), 0.0)


def bipartite_match(similarity: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy bipartite matching (reference ``bipartite_match_op.cc``
    BipartiteMatch): min(N, M) times take the global maximum of the
    similarity matrix (the first in row-major order), pair that (row, col)
    when it is positive, and remove both. Returns ``(match_indices [M]
    int32, match_dist [M])``: per column, the matched row or -1.

    similarity: [N, M] (rows = ground truth, cols = priors)."""
    N, M = similarity.shape
    sim = similarity.float()
    cols = torch.arange(M, device=sim.device)
    match_idx = torch.full((M,), -1, dtype=torch.int32, device=sim.device)
    match_dist = sim.new_zeros(M)
    for _ in range(min(N, M)):
        flat = torch.argmax(sim)
        r, c = flat // M, flat % M
        best = torch.take(sim, flat)  # a tensor index: no host sync
        # only positive similarity counts as a match (the reference leaves
        # zero-overlap columns at -1)
        hit = (cols == c) & (best > 0.0)
        match_idx = torch.where(hit, r.to(torch.int32), match_idx)
        match_dist = torch.where(hit, best, match_dist)
        sim = sim.index_fill(0, r.reshape(1), NEG_INF).index_fill(1, c.reshape(1), NEG_INF)
    return match_idx, match_dist


def _nms_steps(iou: torch.Tensor, scores: torch.Tensor, max_out: int, iou_threshold: float,
               score_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS of each row of ``scores`` [C, N] over the boxes of ``iou``
    [N, N]: ``max_out`` steps, each taking every row's highest live score
    (the first of equal ones) and suppressing its overlaps. Returns
    (selections [C, max_out] int32 padded with -1, counts [C] int32)."""
    c, n = scores.shape
    live = scores > score_threshold
    dead = scores.new_full((), NEG_INF)
    picks = []
    for _ in range(max_out):
        # the first maximum of each row, as argmax takes it
        top, best = torch.max(torch.where(live, scores, dead), dim=1)  # [C]
        ok = top > NEG_INF / 2
        picks.append(torch.where(ok, best, -1))
        keep = ~(iou[best] >= iou_threshold)
        keep.scatter_(1, best[:, None], False)
        live = live & keep & ok[:, None]
    if not picks:
        return (torch.full((c, 0), -1, dtype=torch.int32, device=scores.device),
                torch.zeros(c, dtype=torch.int32, device=scores.device))
    sel = torch.stack(picks, dim=1).to(torch.int32)
    return sel, (sel >= 0).sum(1, dtype=torch.int32)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_out: int,
    iou_threshold: float = 0.3,
    score_threshold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-class NMS with a static output size (the reference's NMSFast
    in ``multiclass_nms_op.cc``): iteratively select the highest-scoring
    live box and suppress overlaps. Returns ``(indices [max_out] int32
    padded with -1, count)``. ``scores`` may have a leading class axis
    [C, N] (the JAX package's ``vmap`` over classes): then both outputs
    have it too, and the boxes' IoU is built once for all classes."""
    iou = iou_similarity(boxes, boxes)  # [n, n]
    if scores.dim() == 1:
        sel, count = _nms_steps(iou, scores[None], max_out, iou_threshold, score_threshold)
        return sel[0], count[0]
    return _nms_steps(iou, scores, max_out, iou_threshold, score_threshold)


def multiclass_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    score_threshold: float = 0.01,
    nms_threshold: float = 0.3,
    nms_top_k: int = 64,
    keep_top_k: int = 100,
    background_label: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-class NMS (reference ``multiclass_nms_op.cc`` MultiClassNMS +
    MultiClassOutput): NMS of every non-background class (one loop over a
    class axis), then the global ``keep_top_k`` by score. Fixed-shape
    output: ``(dets [keep_top_k, 6], count)`` with rows [class, score, x1,
    y1, x2, y2], padding class -1.

    boxes: [N, 4] shared across classes; scores: [C, N]."""
    C, N = scores.shape
    every = torch.arange(C, dtype=torch.int32, device=scores.device)
    cls_ids = torch.cat([every[:background_label], every[background_label + 1:]])
    fg_scores = scores[cls_ids.long()]  # [C-1, N]
    sel, _ = nms(boxes, fg_scores, nms_top_k, nms_threshold, score_threshold)  # [C-1, top_k]
    valid = sel >= 0
    safe = sel.clamp_min(0).long()  # an index: not differentiated
    cls = torch.where(valid, cls_ids[:, None], -1).float().reshape(-1)
    score = torch.where(valid, torch.gather(fg_scores, 1, safe), NEG_INF).reshape(-1)
    box = boxes[safe.reshape(-1)]
    k = min(keep_top_k, score.shape[0])
    top_scores, top_idx = om.topk(score, k)
    valid = top_scores > NEG_INF / 2
    out = torch.cat([
        torch.where(valid, cls[top_idx], -1.0)[:, None],
        torch.where(valid, top_scores, 0.0)[:, None],
        torch.where(valid[:, None], box[top_idx], 0.0),
    ], dim=1)
    if k < keep_top_k:
        out = torch.cat([out, out.new_full((keep_top_k - k, 6), -1.0)])
    return out, valid.sum(dtype=torch.int32)


def target_assign(
    targets: torch.Tensor,
    match_indices: torch.Tensor,
    mismatch_value: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter row targets to matched columns (reference
    ``target_assign_op.h``): ``targets`` [N, D], ``match_indices`` [M]
    (row index or -1) → ``(out [M, D], weight [M])`` with mismatch rows
    filled with ``mismatch_value`` and weight 0."""
    matched = match_indices >= 0
    safe = match_indices.clamp_min(0).long()  # an index: not differentiated
    out = torch.where(matched[:, None], targets[safe], mismatch_value)
    return out, matched.float()


def box_clip(boxes: torch.Tensor, image_shape: Tuple[float, float]) -> torch.Tensor:
    """Clip boxes to image bounds (reference ``box_clip`` in bbox_util.h);
    a coordinate on a bound takes half its gradient, as under ``jnp.clip``."""
    h, w = image_shape
    return torch.stack([
        om.clip(boxes[..., 0], 0.0, w),
        om.clip(boxes[..., 1], 0.0, h),
        om.clip(boxes[..., 2], 0.0, w),
        om.clip(boxes[..., 3], 0.0, h),
    ], dim=-1)


def detection_output(
    loc: torch.Tensor,
    scores: torch.Tensor,
    prior_boxes: torch.Tensor,
    prior_variances: torch.Tensor,
    background_label: int = 0,
    nms_threshold: float = 0.3,
    nms_top_k: int = 400,
    keep_top_k: int = 200,
    score_threshold: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD inference head (reference ``detection_output`` in
    ``layers/detection.py`` = box_coder decode + multiclass_nms): decode
    per-prior location offsets against the priors, then multi-class NMS
    over the class scores. ``loc`` [P, 4], ``scores`` [P, C]
    (post-softmax), priors/variances [P, 4]. Returns (dets [keep_top_k, 6],
    count)."""
    boxes = box_coder(prior_boxes, prior_variances, loc, "decode_center_size")
    return multiclass_nms(boxes, scores.T, score_threshold=score_threshold,
                          nms_threshold=nms_threshold, nms_top_k=nms_top_k,
                          keep_top_k=keep_top_k, background_label=background_label)


def ssd_loss(
    loc: torch.Tensor,
    confidence: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    prior_boxes: torch.Tensor,
    prior_variances: torch.Tensor,
    background_label: int = 0,
    overlap_threshold: float = 0.5,
    neg_pos_ratio: float = 3.0,
    loc_loss_weight: float = 1.0,
    conf_loss_weight: float = 1.0,
) -> torch.Tensor:
    """MultiBox SSD training loss (reference fluid
    ``layers.detection.ssd_loss``: bipartite_match → target_assign →
    smooth_l1 + softmax CE with hard negative mining at
    ``neg_pos_ratio``). One image: ``loc`` [P, 4] predicted offsets,
    ``confidence`` [P, C] logits, ``gt_boxes`` [G, 4] (padded; ``gt_valid``
    [G] bool), ``gt_labels`` [G] int. Returns the scalar loss.

    Matching is bipartite plus a per-prior IoU threshold (the reference's
    per_prediction mode); negative mining ranks the background losses with
    a stable sort (matched priors all tie at NEG_INF and keep their order,
    as under ``jnp.argsort``)."""
    P, C = confidence.shape
    sim = iou_similarity(gt_boxes, prior_boxes)  # [G, P]
    sim = torch.where(gt_valid[:, None], sim, 0.0)
    match_idx, _ = bipartite_match(sim)  # per-prior gt or -1
    # per_prediction augmentation: any prior with IoU >= threshold matches
    best, best_gt = torch.max(sim, dim=0)
    extra = (best >= overlap_threshold) & (match_idx < 0)
    match_idx = torch.where(extra, best_gt.to(torch.int32), match_idx)

    matched = match_idx >= 0
    safe_gt = match_idx.clamp_min(0).long()  # an index and a count: not differentiated
    n_pos = matched.sum(dtype=torch.int32).clamp_min(1)

    # localization loss on matched priors (gt encoded against the priors)
    g = gt_boxes[safe_gt]
    pcx, pcy, pw, ph = _box_to_cwh(prior_boxes)
    gcx, gcy, gw, gh = _box_to_cwh(g)
    var = prior_variances
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's (here and below)
    pw_, ph_ = pw.clamp_min(1e-6), ph.clamp_min(1e-6)
    t = torch.stack([
        (gcx - pcx) / pw_ / var[:, 0],
        (gcy - pcy) / ph_ / var[:, 1],
        torch.log(gw.clamp_min(1e-6) / pw_) / var[:, 2],
        torch.log(gh.clamp_min(1e-6) / ph_) / var[:, 3],
    ], dim=-1)
    diff = om.abs(loc - t)
    loc_l = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    loc_loss = torch.where(matched, loc_l, 0.0).sum() / n_pos

    # confidence loss with hard negative mining
    labels = torch.where(matched, gt_labels.to(torch.int32)[safe_gt], background_label).long()
    logp = torch.log_softmax(confidence.float(), dim=-1)
    ce = -torch.gather(logp, 1, labels[:, None])[:, 0]  # [P]
    neg_ce = -logp[:, background_label]
    n_neg = om.minimum((neg_pos_ratio * n_pos).to(torch.int32), P - n_pos)
    neg_scores = torch.where(matched, NEG_INF, neg_ce)
    order = torch.sort(-neg_scores, stable=True).indices
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(P, device=order.device))
    neg_sel = ~matched & (rank < n_neg)
    conf_loss = torch.where(matched | neg_sel, ce, 0.0).sum() / n_pos
    return loc_loss_weight * loc_loss + conf_loss_weight * conf_loss


def detection_map(
    dets: torch.Tensor,
    det_count: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    overlap_threshold: float = 0.5,
    ap_version: str = "integral",
) -> torch.Tensor:
    """Mean average precision over detection output (reference
    ``detection_map_op.cc``): greedy-match detections (sorted by score, a
    stable sort) to unmatched same-class gt at IoU >= threshold, accumulate
    per-class precision/recall, AP by the integral rule. One image;
    ``dets`` [K, 6] rows [class, score, x1, y1, x2, y2] (class -1 = pad).
    ``ap_version`` is accepted and, as in the JAX package, only the
    integral rule is computed."""
    K = dets.shape[0]
    dev = dets.device
    cls = dets[:, 0].to(torch.int32)
    boxes = dets[:, 2:6]
    valid_det = (torch.arange(K, device=dev) < det_count) & (cls >= 0)
    order = torch.sort(-torch.where(valid_det, dets[:, 1], NEG_INF), stable=True).indices
    cls, boxes, valid_det = cls[order], boxes[order], valid_det[order]

    labels = gt_labels.to(torch.int32)
    iou = iou_similarity(boxes, gt_boxes)  # [K, G]
    cand = iou * (cls[:, None] == labels[None, :]).float() * gt_valid[None, :].float()
    gt_used = torch.zeros(gt_boxes.shape[0], dtype=torch.bool, device=dev)
    gt_ids = torch.arange(gt_boxes.shape[0], device=dev)
    tps = []
    for i in range(K):
        row = torch.where(gt_used, 0.0, cand[i])
        j = torch.argmax(row)
        ok = valid_det[i] & (torch.take(row, j) >= overlap_threshold)
        gt_used = gt_used | ((gt_ids == j) & ok)
        tps.append(ok)
    tp = torch.stack(tps).float() if tps else cand.new_zeros(0)
    fp = torch.where(valid_det, 1.0 - tp, 0.0)

    # per-class AP, all classes at once: [C-1, K]
    classes = torch.arange(1, num_classes, device=dev, dtype=torch.int32)[:, None]
    m = (cls[None, :] == classes) & valid_det[None, :]
    n_gt = ((labels[None, :] == classes) & gt_valid[None, :]).sum(1, dtype=torch.int32)  # [C-1]
    tpc = torch.cumsum(torch.where(m, tp, 0.0), dim=1)
    fpc = torch.cumsum(torch.where(m, fp, 0.0), dim=1)
    recall = tpc / n_gt.clamp_min(1)[:, None]  # counts: not differentiated
    precision = tpc / (tpc + fpc).clamp_min(1e-8)
    dr = torch.diff(recall, dim=1, prepend=recall.new_zeros(recall.shape[0], 1))
    aps = torch.where(n_gt > 0, torch.where(m, precision * dr, 0.0).sum(1), torch.nan)
    present = ~torch.isnan(aps)
    mean = torch.where(present, aps, 0.0).sum() / present.sum().clamp_min(1)
    return torch.where(present.any(), mean, 0.0)

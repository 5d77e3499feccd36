"""The port's ``ops.detection``, ``ops.detection_rpn``, ``ops.quant`` and
``layers.multi_box_head`` against the JAX package's, on the CPU in f32, on
the same numpy-seeded inputs at small sizes (100 priors, 8 padded ground
truths).

Tolerances: forward outputs within 1e-5 relative L2 (a 1e-6 absolute floor
near 0; ``roi_perspective_transform`` 1e-4, its 8×8 solves run through
LAPACK in both packages but in another order of operations), gradients
(the JAX grad of ``sum(out * c)`` for a fixed cotangent ``c`` against
autograd's) within 1e-4 relative L2; integer outputs equal, int32 as in the
JAX package. The inputs hold zero-width boxes, boxes that share edges (ties
in every ``maximum``/``minimum`` of the IoU) and exactly tied scores: the
selections' order must be equal there. The samplers are given the JAX
package's priorities, and are held by their distribution on their own. An
SSD step (``multi_box_head`` → ``ssd_loss`` over two images of two maps)
and an RPN step (``anchor_generator`` → ``rpn_target_assign`` → the loss)
are held, loss and every gradient, against ``jax.grad`` of the same step,
the weights carried across by ``convert.params_from_jax``.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.ops import detection as jdet
from paddle_tpu.ops import detection_rpn as jrpn
from paddle_tpu.ops import quant as jq
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import detection as tdet
from paddle_tpu_torch.ops import detection_rpn as trpn
from paddle_tpu_torch.ops import quant as tq

FWD_RTOL, FWD_FLOOR, GRAD_RTOL, WARP_RTOL = 1e-5, 1e-6, 1e-4, 1e-4
R = np.random.RandomState(16)
J = {"det": jdet, "rpn": jrpn, "q": jq}
T = {"det": tdet, "rpn": trpn, "q": tq}


def _x(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def _dev(m):
    """The port's creation ops take device="cpu" here (their default is CUDA)."""
    return {"device": "cpu"} if m is T else {}


# 100 priors on a 5 x 5 map: 4 a cell (ar 1, 2, 1/2, and the max size)
_PB, _PV = (np.asarray(a) for a in jdet.prior_box((5, 5), (100, 100), [20.0], [40.0], [2.0],
                                                  flip=True))
PRIORS, PVARS = _PB.reshape(-1, 4), _PV.reshape(-1, 4)
# ground truth on the priors' grid, so edges coincide with prior edges; one
# zero-width box; two padded rows
GT = np.array([[0.1, 0.1, 0.3, 0.3], [0.5, 0.3, 0.9, 0.7], [0.3, 0.3, 0.3, 0.7],
               [0.0, 0.6, 0.4, 1.0], [0.6, 0.0, 1.0, 0.2], [0.3, 0.5, 0.7, 0.9],
               [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
GT_VALID = np.array([True] * 6 + [False] * 2)
GT_LABELS = np.array([1, 2, 1, 3, 2, 3, 0, 0], np.int32)
LOC = _x(100, 4, scale=0.1)
CONF = _x(100, 4)
SCORES = np.asarray(jax.nn.softmax(jnp.asarray(CONF), axis=-1))
# boxes for NMS: a cluster of near-duplicates, a zero-width box, two boxes
# with one score (a tie)
NBOX = np.concatenate([GT[:6], GT[:6] + 0.02, np.array([[0.2, 0.2, 0.2, 0.5]], np.float32),
                       np.abs(_x(7, 4, scale=0.3)).cumsum(1).astype(np.float32)])  # [20, 4]
NSCORE = R.uniform(0.0, 1.0, 20).astype(np.float32)
NSCORE[[3, 9, 17]] = NSCORE[5]  # exact ties
CSCORE = R.uniform(0.0, 1.0, (4, 20)).astype(np.float32)
CSCORE[2, [1, 4, 11]] = CSCORE[2, 0]
CSCORE[1, 6] = CSCORE[3, 6]
# a similarity matrix with tied maxima
SIM = np.round(R.uniform(0, 1, (5, 9)), 1).astype(np.float32)
SIM[2, 4] = SIM[4, 7] = SIM.max()
SIM[3] = 0.0
EDGE_BOXES = np.array([[0.0, -1.0, 40.0, 30.0], [5.0, 30.0, 50.0, 30.0], [-3.0, 10.0, 12.0, 31.0]],
                      np.float32)

# (id, fn(modules, *args), args, grad argnums)
CASES = [
    ("prior_box", lambda m: m["det"].prior_box((5, 6), (120, 100), [20.0, 30.0], [40.0, 50.0],
                                               [2.0, 3.0], flip=True, **_dev(m)), [], ()),
    ("prior_box_clip_step", lambda m: m["det"].prior_box((3, 4), (60, 80), [30.0], (), [2.0],
                                                         clip=True, step=(20.0, 16.0), offset=0.25,
                                                         **_dev(m)), [], ()),
    ("anchor_generator", lambda m: m["det"].anchor_generator((4, 5), **_dev(m)), [], ()),
    ("anchor_generator_sizes", lambda m: m["det"].anchor_generator(
        (2, 3), (32.0, 48.0), (1.0, 2.0), (1.0, 1.0, 1.0, 1.0), (8.0, 12.0), 0.0, **_dev(m)), [], ()),
    ("box_coder_encode", lambda m, p, v, t: m["det"].box_coder(p, v, t),
     [PRIORS, PVARS, GT[[0, 1, 3, 4, 5]]], (0, 2)),
    ("box_coder_encode_zero_width", lambda m, p, v, t: m["det"].box_coder(p, v, t),
     [PRIORS, PVARS, GT[:6]], ()),
    ("box_coder_decode", lambda m, p, v, c: m["det"].box_coder(p, v, c, "decode_center_size"),
     [PRIORS, PVARS, _x(3, 100, 4, scale=0.2)], (0, 2)),
    ("box_coder_decode_2d", lambda m, p, v, c: m["det"].box_coder(p, v, c, "decode_center_size"),
     [PRIORS, PVARS, LOC], (0, 2)),
    ("iou_similarity", lambda m, x, y: m["det"].iou_similarity(x, y), [GT, PRIORS], (0, 1)),
    ("iou_similarity_self_ties", lambda m, x: m["det"].iou_similarity(x, x), [NBOX], (0,)),
    ("bipartite_match", lambda m, s: m["det"].bipartite_match(s), [SIM], (0,)),
    ("bipartite_match_wide", lambda m, s: m["det"].bipartite_match(s), [SIM.T.copy()], (0,)),
    ("nms", lambda m, b, s: m["det"].nms(b, s, 8, 0.3, 0.1), [NBOX, NSCORE], ()),
    ("nms_all_steps", lambda m, b, s: m["det"].nms(b, s, 20, 0.5), [NBOX, NSCORE], ()),
    ("multiclass_nms", lambda m, b, s: m["det"].multiclass_nms(b, s, 0.05, 0.4, 6, 10),
     [NBOX, CSCORE], ()),
    ("multiclass_nms_pad", lambda m, b, s: m["det"].multiclass_nms(b, s, 0.5, 0.3, 3, 40, 2),
     [NBOX, CSCORE], ()),
    ("target_assign", lambda m, t, i: m["det"].target_assign(t, i, -1.5),
     [_x(5, 3), np.array([2, -1, 0, 4, -1, 2], np.int32)], (0,)),
    ("box_clip", lambda m, b: m["det"].box_clip(b, (30.0, 40.0)), [EDGE_BOXES], (0,)),
    ("detection_output", lambda m, l, s, p, v: m["det"].detection_output(l, s, p, v, 0, 0.45, 30, 25),
     [LOC, SCORES, PRIORS, PVARS], ()),
    ("ssd_loss", lambda m, l, c, g, y, v, p, pv: m["det"].ssd_loss(l, c, g, y, v, p, pv),
     [LOC, CONF, GT, GT_LABELS, GT_VALID, PRIORS, PVARS], (0, 1, 2)),
    ("ssd_loss_ratio", lambda m, l, c, g, y, v, p, pv: m["det"].ssd_loss(
        l, c, g, y, v, p, pv, 0, 0.3, 1.5, 2.0, 0.5),
     [LOC, CONF, GT, GT_LABELS, GT_VALID, PRIORS, PVARS], (0, 1)),
    ("detection_map", lambda m, l, s, p, v, g, y, gv: m["det"].detection_map(
        *m["det"].detection_output(l, s, p, v, 0, 0.45, 30, 25), g, y, gv, 4, 0.3),
     [LOC, SCORES, PRIORS, PVARS, GT, GT_LABELS, GT_VALID], ()),
    ("detection_map_hits", lambda m, d, n, g, y, gv: m["det"].detection_map(d, n, g, y, gv, 4),
     [np.concatenate([np.stack([GT_LABELS[:6].astype(np.float32), np.float32([.9, .8, .8, .7, .2, .6]),
                                ], 1), GT[:6] + 0.01], 1), np.array(5, np.int32), GT, GT_LABELS,
      GT_VALID], ()),
    ("polygon_box_transform", lambda m, x: m["rpn"].polygon_box_transform(x), [_x(2, 4, 3, 5)], (0,)),
    ("fake_quantize_abs_max", lambda m, x: m["q"].fake_quantize_abs_max(x), [_x(4, 6)], (0,)),
    ("fake_quantize_abs_max_tied_max", lambda m, x: m["q"].fake_quantize_abs_max(x, 4),
     [np.float32([[0.5, -2.0, 2.0], [0.0, 1.3, -0.7]])], (0,)),
    ("fake_channel_wise_quantize_abs_max", lambda m, x: m["q"].fake_channel_wise_quantize_abs_max(
        x, 8, -1), [_x(3, 3, 2, 5)], (0,)),
    ("fake_quantize_moving_average_abs_max", lambda m, x, s: m["q"].fake_quantize_moving_average_abs_max(
        x, s, 6, 0.8), [_x(4, 6), np.float32(1.5)], (0, 1)),
    ("fake_quantize_moving_average_abs_max_test",
     lambda m, x, s: m["q"].fake_quantize_moving_average_abs_max(x, s, 8, is_test=True),
     [_x(4, 6), np.float32(1.1)], (0, 1)),
    ("fake_dequantize_max_abs", lambda m, x, s: m["q"].fake_dequantize_max_abs(x, s, 127.0),
     [np.round(_x(4, 6) * 40), np.float32(2.5)], (0, 1)),
]


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _close(name, got, want, rtol, floor):
    """Within ``rtol`` relative L2 where ``want`` is finite; equal where it
    is not (log of a zero-width box is -inf in both)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=name)
    err = np.linalg.norm(np.where(finite, got - want, 0.0))
    assert err <= rtol * max(np.linalg.norm(np.where(finite, want, 0.0)), floor), (name, err)


def _held(name, got, want, rtol=FWD_RTOL):
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.kind in "biu":
            assert str(g.dtype).replace("torch.", "") == w.dtype.name, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            assert g.dtype == torch.float32, (name, g.dtype)
            _close(name, g.detach().numpy(), w, rtol, FWD_FLOOR)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax(case):
    name, fn, args, _ = case
    want = _flat(jax.jit(lambda *xs: fn(J, *xs))(*(jnp.asarray(a) for a in args)))
    got = _flat(fn(T, *(torch.from_numpy(np.array(a)) for a in args)))
    _held(name, got, want)


GRAD_CASES = [c for c in CASES if c[3]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradient_matches_jax(case):
    name, fn, args, argnums = case
    outs = _flat(jax.jit(lambda *xs: fn(J, *xs))(*(jnp.asarray(a) for a in args)))
    r = np.random.RandomState(5)
    cts = [np.asarray(r.randn(*np.shape(o)), np.float32) for o in outs]

    def j_loss(*xs):
        return sum(jnp.sum(o * c) for o, c in zip(_flat(fn(J, *xs)), cts)
                   if jnp.issubdtype(o.dtype, jnp.floating))

    want = jax.jit(jax.grad(j_loss, argnums=argnums))(*(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(np.array(a)) for a in args]
    for i in argnums:
        ts[i].requires_grad_(True)
    loss = sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(_flat(fn(T, *ts)), cts)
               if o.is_floating_point())
    got = torch.autograd.grad(loss, [ts[i] for i in argnums])
    for i, g, w in zip(argnums, got, want):
        _close(f"{name} d/darg{i}", g.numpy(), w, GRAD_RTOL, 1e-8)


def test_every_function_is_held_and_the_exports_are_the_jax_package():
    assert tdet.__all__ == jdet.__all__ and trpn.__all__ == jrpn.__all__ and tq.__all__ == jq.__all__
    held = {c[0] for c in CASES} | {"rpn_target_assign", "generate_proposals",
                                    "generate_proposal_labels", "roi_perspective_transform"}
    for n in tdet.__all__ + trpn.__all__ + tq.__all__:
        assert any(h == n or h.startswith(n + "_") for h in held), n


def test_nms_over_a_class_axis_is_the_jax_vmap():
    """The port's nms takes [C, N] scores in one loop; JAX's vmaps it."""
    want = jax.jit(jax.vmap(lambda s: jdet.nms(jnp.asarray(NBOX), s, 7, 0.35, 0.2)))(
        jnp.asarray(CSCORE))
    got = tdet.nms(torch.from_numpy(NBOX), torch.from_numpy(CSCORE), 7, 0.35, 0.2)
    _held("nms_classes", got, want)


# ------------------------------------------------------------ RPN ops

ANCHORS = np.asarray(jdet.anchor_generator((6, 7), (16.0, 32.0), (0.5, 1.0, 2.0),
                                           stride=(8.0, 8.0))[0]).reshape(-1, 4)  # [252, 4]
RPN_GT = np.array([[10.0, 12.0, 40.0, 36.0], [20.0, 4.0, 28.0, 44.0], [30.0, 30.0, 30.0, 40.0],
                   [0.0, 0.0, 0.0, 0.0]], np.float32)
RPN_VALID = np.array([True, True, True, False])


def _jax_priorities(key, n):
    """The two uniform vectors the JAX package's samplers draw from ``key``."""
    r1, r2 = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(r1, (n,))), np.asarray(jax.random.uniform(r2, (n,)))])


@pytest.mark.parametrize("kw", [dict(), dict(rpn_batch_size_per_im=24, fg_fraction=0.25,
                                             rpn_positive_overlap=0.5, rpn_negative_overlap=0.2)],
                         ids=["defaults", "small_batch"])
def test_rpn_target_assign_on_the_jax_priorities(kw):
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda *xs: jrpn.rpn_target_assign(*xs, **kw))(
        jnp.asarray(ANCHORS), jnp.asarray(RPN_GT), jnp.asarray(RPN_VALID), key)
    got = trpn.rpn_target_assign(torch.from_numpy(ANCHORS), torch.from_numpy(RPN_GT),
                                 torch.from_numpy(RPN_VALID), None, **kw,
                                 uniforms=torch.from_numpy(_jax_priorities(key, len(ANCHORS))))
    _held("rpn_target_assign", got, want)
    assert int((got[0] == 1).sum()) > 0 and int((got[0] == 0).sum()) > 0


PROP_SCORES = R.uniform(0, 1, len(ANCHORS)).astype(np.float32)
PROP_SCORES[[7, 40, 41, 200]] = PROP_SCORES[100]
PROP_DELTAS = _x(len(ANCHORS), 4, scale=0.2)
ROIS = np.concatenate([RPN_GT[:3] + 1.0, np.asarray(ANCHORS[::6]) + _x(42, 4, scale=2.0)])


@pytest.mark.parametrize("kw", [dict(pre_nms_top_n=120, post_nms_top_n=30, nms_thresh=0.6),
                                dict(pre_nms_top_n=400, post_nms_top_n=300, nms_thresh=0.3,
                                     min_size=6.0)], ids=["top120", "pad_min_size"])
def test_generate_proposals_matches_jax(kw):
    args = (PROP_SCORES, PROP_DELTAS, ANCHORS, np.full_like(ANCHORS, 0.5))
    want = jax.jit(lambda *xs: jrpn.generate_proposals(*xs, (50.0, 60.0), **kw))(
        *(jnp.asarray(a) for a in args))
    got = trpn.generate_proposals(*(torch.from_numpy(a) for a in args), (50.0, 60.0), **kw)
    _held("generate_proposals", got, want)


def test_generate_proposal_labels_on_the_jax_priorities():
    key = jax.random.PRNGKey(8)
    labels = np.array([3, 1, 2, 0], np.int32)
    args = (ROIS, RPN_GT, labels, RPN_VALID)
    want = jax.jit(lambda *xs: jrpn.generate_proposal_labels(*xs, 16, 0.25, 0.4, 0.4))(
        *(jnp.asarray(a) for a in args), key)
    got = trpn.generate_proposal_labels(*(torch.from_numpy(a) for a in args), None, 16, 0.25, 0.4,
                                        0.4, uniforms=torch.from_numpy(_jax_priorities(key, len(ROIS))))
    _held("generate_proposal_labels", got, want)
    assert int((got[0] > 0).sum()) > 0


def test_samplers_draw_fg_and_bg_at_their_counts_and_uniformly():
    """From a generator: fg = min(#eligible, k_fg), bg fills the batch, and
    every eligible anchor is drawn about equally often."""
    anchors, gt, valid = (torch.from_numpy(a) for a in (ANCHORS, RPN_GT, RPN_VALID))
    ref = trpn.rpn_target_assign(anchors, gt, valid, None, 20, 0.5, 0.5, 0.2,
                                 uniforms=torch.ones(2, len(ANCHORS)))[0]
    n_fg_elig = int((ref == 1).sum())  # with all-equal priorities: the first k of each set
    hits = torch.zeros(len(ANCHORS))
    for seed in range(300):
        lab = trpn.rpn_target_assign(anchors, gt, valid, torch.Generator().manual_seed(seed), 20, 0.5,
                                     0.5, 0.2)[0]
        assert int((lab == 1).sum()) == min(n_fg_elig, 10)
        assert int((lab == 0).sum()) == 20 - min(n_fg_elig, 10)
        hits += (lab == 0).float()
    iou = tdet.iou_similarity(gt[valid], anchors).amax(0)
    bg_elig = (iou < 0.2) & (ref != 1)
    rate = hits[bg_elig] / 300
    expect = (20 - min(n_fg_elig, 10)) / int(bg_elig.sum())
    assert float((rate - expect).abs().max()) < 0.1 and float(hits[~bg_elig & (ref != 1)].sum()) == 0


def test_samplers_draw_from_the_apply_generator_by_default():
    """With neither ``rng`` nor ``uniforms``, both samplers draw from the
    running apply's generator: one seed gives one result, the explicit
    generator's, and an apply given no ``rng`` raises, naming it."""
    anchors, gt, valid = (torch.from_numpy(a) for a in (ANCHORS, RPN_GT, RPN_VALID))
    rois, gt_l = torch.from_numpy(ROIS), torch.tensor([3, 1, 2, 0], dtype=torch.int32)

    def net(x):
        lab = trpn.rpn_target_assign(anchors, gt, valid, None, 20, 0.5, 0.5, 0.2)[0]
        rl = trpn.generate_proposal_labels(rois, gt, gt_l, valid, None, 16, 0.25, 0.4, 0.4)[0]
        return tpt.layers.fc(x, 1, bias_attr=False) * 0.0, lab, rl

    model = tpt.build(net)
    x = torch.zeros(1, 2)
    v = model.init(0, x, device="cpu")
    (_, lab, rl), _ = model.apply(v, x, rng=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    assert torch.equal(lab, trpn.rpn_target_assign(anchors, gt, valid, g, 20, 0.5, 0.5, 0.2)[0])
    assert torch.equal(rl, trpn.generate_proposal_labels(rois, gt, gt_l, valid, g, 16, 0.25, 0.4, 0.4)[0])
    with pytest.raises(Exception, match="rng"):
        model.apply(v, x)


def test_roi_perspective_transform_matches_jax():
    x = _x(1, 12, 14, 3)
    rois = np.array([[1.0, 1.0, 9.0, 2.0, 10.0, 8.0, 0.0, 7.0],
                     [3.0, 3.0, 11.0, 3.0, 11.0, 10.0, 3.0, 10.0],
                     [-4.0, 2.0, 20.0, 0.0, 18.0, 15.0, -1.0, 13.0]], np.float32)
    # at 0.75 no sample falls on an integer coordinate, where the bilinear
    # gradient jumps and a last-ulp difference of the solves would pick
    # another cell
    fn = lambda m, a, r: m.roi_perspective_transform(a, r, 5, 6, 0.75)  # noqa: E731
    want = jax.jit(lambda a, r: fn(jrpn, a, r))(jnp.asarray(x), jnp.asarray(rois))
    tx, tr = torch.from_numpy(x).requires_grad_(), torch.from_numpy(rois).requires_grad_()
    got = fn(trpn, tx, tr)
    _close("roi_perspective_transform", got.detach().numpy(), want, WARP_RTOL, FWD_FLOOR)
    ct = np.random.RandomState(2).randn(*want.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda a, r: jnp.sum(fn(jrpn, a, r) * ct), (0, 1)))(jnp.asarray(x),
                                                                           jnp.asarray(rois))
    tg = torch.autograd.grad((got * torch.from_numpy(ct)).sum(), (tx, tr))
    for g, w, n in zip(tg, jg, ("x", "rois")):
        _close(f"roi_perspective_transform d/d{n}", g.numpy(), w, WARP_RTOL, 1e-8)


# ------------------------------------------------------------ the steps

def _ssd_net(pt):
    def net(f1, f2, gt, labels, valid):
        locs, confs, boxes, variances = pt.layers.multi_box_head(
            [f1, f2], (64, 64), 3, [16.0, 32.0], [32.0, 48.0], [[2.0], [2.0, 3.0]])
        per_image = [pt.layers.ssd_loss(locs[i], confs[i], gt[i], labels[i], valid[i], boxes,
                                        variances) for i in range(f1.shape[0])]
        return sum(per_image) / len(per_image)
    return net


def _step_against_jax(net_of, args, expect_names):
    jmodel, tmodel = jpt.build(net_of(jpt)), tpt.build(net_of(tpt))
    jv = jax.jit(lambda *xs: jmodel.init(0, *xs))(*(jnp.asarray(a) for a in args))
    assert set(jv.params) == expect_names
    tv = tmodel.init(0, *(torch.from_numpy(a) for a in args), device="cpu")
    assert {n: tuple(p.shape) for n, p in tv.params.items()} == {n: p.shape for n, p in jv.params.items()}
    params = convert.params_from_jax({n: np.asarray(p) for n, p in jv.params.items()}, "cpu")
    params = {n: p.requires_grad_() for n, p in params.items()}

    def j_loss(p):
        return jmodel.apply(jpt.framework.Variables(p, jv.state), *(jnp.asarray(a) for a in args))[0]

    jl, jg = jax.jit(jax.value_and_grad(j_loss))(jv.params)
    tl, _ = tmodel.apply(params, *(torch.from_numpy(a) for a in args))
    tg = torch.autograd.grad(tl, list(params.values()))
    _close("loss", tl.detach().numpy(), jl, FWD_RTOL, FWD_FLOOR)
    for (n, _), g in zip(params.items(), tg):
        _close(f"d/d{n}", g.numpy(), jg[n], GRAD_RTOL, 1e-8)
    return float(tl)


def test_ssd_step_loss_and_gradients_match_jax():
    r = np.random.RandomState(30)
    f1, f2 = r.randn(2, 4, 4, 6).astype(np.float32), r.randn(2, 2, 2, 8).astype(np.float32)
    gt = np.stack([GT[:4], GT[[1, 3, 5, 6]]])
    labels = np.stack([GT_LABELS[:4], np.array([2, 3, 1, 0], np.int32)]) % 3
    valid = np.array([[True, True, True, False], [True, True, True, False]])
    names = {f"multi_box_head/{k}_{i}/{p}" for k in ("loc", "conf") for i in (0, 1) for p in ("w", "b")}
    loss = _step_against_jax(_ssd_net, (f1, f2, gt, labels, valid), names)
    assert np.isfinite(loss) and loss > 0


def _rpn_net(pt):
    anchors = None

    def net(feat, gt, valid, u):
        nonlocal anchors
        h = pt.layers.conv2d(feat, 16, 3, padding=1, act="relu", name="rpn_conv")
        cls = pt.layers.conv2d(h, 6, 1, name="rpn_cls").reshape(-1)
        box = pt.layers.conv2d(h, 24, 1, name="rpn_bbox").reshape(-1, 4)
        kw = {} if pt is jpt else {"device": "cpu"}
        a, _ = pt.layers.anchor_generator((feat.shape[1], feat.shape[2]), (16.0, 32.0),
                                          (0.5, 1.0, 2.0), stride=(8.0, 8.0), **kw)
        a = a.reshape(-1, 4)
        if pt is jpt:
            labels, targets, loc_w, score_w = pt.layers.rpn_target_assign(a, gt, valid, u, 32)
        else:
            labels, targets, loc_w, score_w = pt.layers.rpn_target_assign(a, gt, valid, None, 32,
                                                                          uniforms=u)
        ce = pt.layers.sigmoid_cross_entropy_with_logits(cls, (labels == 1).astype(cls.dtype)
                                                         if pt is jpt else (labels == 1).float())
        sl1 = pt.layers.smooth_l1(box * loc_w[:, None], targets * loc_w[:, None])
        return (ce * score_w).sum() / score_w.sum() + sl1.sum() / (loc_w.sum() + 1.0)

    return net


def test_rpn_step_loss_and_gradients_match_jax():
    r = np.random.RandomState(31)
    feat = r.randn(1, 6, 7, 8).astype(np.float32)
    key = jax.random.PRNGKey(4)
    u = _jax_priorities(key, 6 * 7 * 6)
    jmodel, tmodel = jpt.build(_rpn_net(jpt)), tpt.build(_rpn_net(tpt))
    jargs = (jnp.asarray(feat), jnp.asarray(RPN_GT), jnp.asarray(RPN_VALID), key)
    targs = (torch.from_numpy(feat), torch.from_numpy(RPN_GT), torch.from_numpy(RPN_VALID),
             torch.from_numpy(u))
    jv = jax.jit(lambda *xs: jmodel.init(0, *xs))(*jargs)
    params = {n: p.requires_grad_() for n, p in convert.params_from_jax(
        {n: np.asarray(p) for n, p in jv.params.items()}, "cpu").items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply(jpt.framework.Variables(p, jv.state), *jargs)[0]))(jv.params)
    tl, _ = tmodel.apply(params, *targs)
    tg = torch.autograd.grad(tl, list(params.values()))
    _close("rpn loss", tl.detach().numpy(), jl, FWD_RTOL, FWD_FLOOR)
    for (n, _), g in zip(params.items(), tg):
        _close(f"rpn d/d{n}", g.numpy(), jg[n], GRAD_RTOL, 1e-8)
    assert set(params) == {f"{k}/{p}" for k in ("rpn_conv", "rpn_cls", "rpn_bbox") for p in "wb"}

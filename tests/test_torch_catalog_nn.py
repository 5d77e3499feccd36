"""The port's new ``ops.nn`` functions, ``ops.nn3d`` and ``ops.vision`` against
the JAX package's, on the CPU in f32, on the same numpy-seeded inputs.

Tolerances: forward outputs within 1e-5 relative L2 (a 1e-6 absolute floor
near 0); gradients (the JAX grad of ``sum(out * c)`` for a fixed cotangent
``c`` against autograd's) within 1e-4 relative L2; integer outputs equal.
Resizes go up and down (the JAX bilinear resize filters when it shrinks);
transposed convolutions run at stride 2 with padding and output padding.
``nce_loss`` is given the JAX package's sampled noise ids, and its sampler
and ``random_crop`` are held by distribution. The ``*_at_kink`` cases sit
exactly on a kink: a logit of 0 in the three logistic losses (whose
gradient there is the JAX package's -label, ROADMAP §C.10), a zero
difference in smooth_l1 and huber_loss, the hinge of margin_rank_loss. The
MNIST conv net at init on a batch whose top half is blank (ReLUs and max
pools at exact zeros and ties) gives the JAX package's gradients.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn as jn
from paddle_tpu.ops import nn3d as j3
from paddle_tpu.ops import vision as jv
from paddle_tpu_torch.ops import nn as tn
from paddle_tpu_torch.ops import nn3d as t3
from paddle_tpu_torch.ops import vision as tv

FWD_RTOL, FWD_FLOOR, GRAD_RTOL = 1e-5, 1e-6, 1e-4
R = np.random.RandomState(21)


def _x(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def _kinkless(*shape):
    x = R.randn(*shape)
    return (x + np.sign(x) * 0.3).astype(np.float32)


IMG = _x(2, 6, 7, 4)
IMG8 = _x(2, 4, 4, 8)
VOL = _x(2, 5, 4, 6, 3)
PROBS = R.uniform(0.05, 0.95, (3, 5)).astype(np.float32)
LABELS01 = (R.uniform(size=(3, 5)) > 0.5).astype(np.float32)
SEQ = _x(3, 6, 4)
LENS = np.array([6, 2, 4], np.int32)
ZLOGIT = np.array([[0.0, 0.0, -0.0, 1.5, 0.0], [0.0, -2.0, 0.0, 0.0, 3.0], [0.0] * 5], np.float32)

# (id, (jax module, port module) -> fn(module, *args), args, grad argnums)
J = {"nn": jn, "nn3d": j3, "vision": jv}
T = {"nn": tn, "nn3d": t3, "vision": tv}
CASES = [
    ("depthwise_conv2d", lambda m, x, w: m["nn"].depthwise_conv2d(x, w, 1, 1),
     [IMG, _x(3, 3, 1, 8)], (0, 1)),
    ("depthwise_conv2d_stride", lambda m, x, w: m["nn"].depthwise_conv2d(x, w, 2, "SAME"),
     [IMG, _x(3, 3, 1, 4)], (0, 1)),
    ("conv2d_transpose", lambda m, x, w: m["nn"].conv2d_transpose(x, w), [IMG, _x(3, 3, 4, 5)], (0, 1)),
    ("conv2d_transpose_s2", lambda m, x, w: m["nn"].conv2d_transpose(x, w, 2), [IMG, _x(3, 3, 4, 5)],
     (0, 1)),
    ("conv2d_transpose_s2_pad", lambda m, x, w: m["nn"].conv2d_transpose(x, w, 2, 1, 1),
     [IMG, _x(4, 3, 4, 5)], (0, 1)),
    ("conv2d_transpose_s2x3", lambda m, x, w: m["nn"].conv2d_transpose(x, w, (2, 3), (1, 0), (0, 2)),
     [IMG, _x(3, 4, 4, 2)], (0, 1)),
    ("maxout", lambda m, x: m["nn"].maxout(x, 2), [IMG8], (0,)),
    ("group_norm", lambda m, x, s, b: m["nn"].group_norm(x, s, b, groups=2),
     [IMG, _x(4), _x(4)], (0, 1, 2)),
    ("group_norm_plain", lambda m, x: m["nn"].group_norm(x, groups=4, epsilon=1e-3), [IMG8], (0,)),
    ("lrn", lambda m, x: m["nn"].lrn(x), [IMG8], (0,)),
    ("lrn_n3", lambda m, x: m["nn"].lrn(x, 3, 2.0, 0.1, 0.5), [IMG], (0,)),
    ("l2_normalize", lambda m, x: m["nn"].l2_normalize(x, 1), [SEQ], (0,)),
    ("log_softmax", lambda m, x: m["nn"].log_softmax(x), [SEQ], (0,)),
    ("log_softmax_axis", lambda m, x: m["nn"].log_softmax(x, 1), [SEQ], (0,)),
    ("sigmoid_cross_entropy_with_logits",
     lambda m, x, y: m["nn"].sigmoid_cross_entropy_with_logits(x, y), [_x(3, 5) * 3, LABELS01],
     (0,)),
    ("sigmoid_cross_entropy_with_logits_at_kink",
     lambda m, x, y: m["nn"].sigmoid_cross_entropy_with_logits(x, y), [ZLOGIT, LABELS01], (0,)),
    ("smooth_l1", lambda m, x, y: m["nn"].smooth_l1(x, y), [_x(3, 2, 4), _x(3, 2, 4)], (0, 1)),
    ("smooth_l1_at_kink", lambda m, x, y: m["nn"].smooth_l1(x, y), [ZLOGIT, ZLOGIT * 0.5], (0, 1)),
    ("huber_loss_at_kink", lambda m, x, y: m["nn"].huber_loss(x, y, 1.5), [ZLOGIT, ZLOGIT * 0.0],
     (0, 1)),
    ("smooth_l1_sigma", lambda m, x, y: m["nn"].smooth_l1(x, y, 3.0), [_x(3, 4), _x(3, 4)], (0, 1)),
    ("huber_loss", lambda m, x, y: m["nn"].huber_loss(x, y, 0.8), [_x(3, 4), _x(3, 4)], (0, 1)),
    ("kldiv_loss", lambda m, x, t: m["nn"].kldiv_loss(x, t), [np.log(PROBS), PROBS[::-1].copy()],
     (0, 1)),
    ("log_loss", lambda m, p, y: m["nn"].log_loss(p, y), [PROBS, LABELS01], (0,)),
    ("margin_rank_loss", lambda m, lab, l, r: m["nn"].margin_rank_loss(lab, l, r, 0.2),
     [np.float32([1, -1, 1, -1]), _kinkless(4), _kinkless(4)], (1, 2)),
    ("margin_rank_loss_at_kink", lambda m, lab, l, r: m["nn"].margin_rank_loss(lab, l, r, 0.25),
     [np.float32([1, -1, 1, -1]), np.float32([1.25, 1.0, 2.0, 0.5]), np.float32([1.0, 1.25, 1.0, 0.5])],
     (1, 2)),
    ("cos_sim", lambda m, x, y: m["nn"].cos_sim(x, y), [SEQ, _x(3, 6, 4)], (0, 1)),
    ("embedding_grad_dense", lambda m, ids, g: m["nn"].embedding_grad_dense((7, 4), ids, g),
     [np.array([[1, 3, 1], [6, 0, 3]], np.int32), _x(2, 3, 4)], (1,)),
    ("prelu", lambda m, x, a: m["nn"].prelu(x, a), [IMG, _x(4) * 0.2], (0, 1)),
    ("pixel_shuffle", lambda m, x: m["nn"].pixel_shuffle(x, 2), [IMG8], (0,)),
    ("pad2d", lambda m, x: m["nn"].pad2d(x, [1, 0, 2, 3], pad_value=0.5), [IMG], (0,)),
    ("pad2d_reflect", lambda m, x: m["nn"].pad2d(x, [2, 1, 1, 2], "reflect"), [IMG], (0,)),
    ("pad2d_edge", lambda m, x: m["nn"].pad2d(x, [0, 2, 3, 1], "edge"), [IMG], (0,)),
    ("resize_nearest_up", lambda m, x: m["nn"].resize_nearest(x, (11, 9)), [IMG], (0,)),
    ("resize_nearest_down", lambda m, x: m["nn"].resize_nearest(x, (4, 3)), [IMG], (0,)),
    ("resize_bilinear_up", lambda m, x: m["nn"].resize_bilinear(x, (11, 13)), [IMG], (0,)),
    ("resize_bilinear_down", lambda m, x: m["nn"].resize_bilinear(x, (4, 3)), [IMG], (0,)),
    ("resize_bilinear_mixed", lambda m, x: m["nn"].resize_bilinear(x, (3, 12)), [IMG], (0,)),
    ("resize_bilinear_aligned_up", lambda m, x: m["nn"].resize_bilinear(x, (11, 13), True), [IMG],
     (0,)),
    ("resize_bilinear_aligned_down", lambda m, x: m["nn"].resize_bilinear(x, (4, 1), True), [IMG],
     (0,)),
    ("matmul_bias", lambda m, x, w, b: m["nn"].matmul_bias(x, w, b), [SEQ, _x(4, 5), _x(5)],
     (0, 1, 2)),
    ("matmul_bias_none", lambda m, x, w: m["nn"].matmul_bias(x, w), [_x(3, 4), _x(4, 2)], (0, 1)),
    ("multiplex", lambda m, a, b, c, i: m["nn"].multiplex([a, b, c], i),
     [_x(4, 3), _x(4, 3), _x(4, 3), np.array([2, 0, 1, 2], np.int32)], (0, 1, 2)),
    ("row_conv", lambda m, x, w: m["nn"].row_conv(x, w), [SEQ, _x(3, 4)], (0, 1)),
    ("row_conv_lengths", lambda m, x, w, l: m["nn"].row_conv(x, w, l), [SEQ, _x(2, 4), LENS],
     (0, 1)),
    ("pad_constant_like", lambda m, x, y: m["nn"].pad_constant_like(x, y, 1.5),
     [_x(4, 5, 3), _x(2, 5, 1)], (1,)),
    ("rank_loss", lambda m, lab, l, r: m["nn"].rank_loss(lab, l, r),
     [np.float32([1, 0, 1, 0.5]), _x(4), _x(4)], (1, 2)),
    ("dice_loss", lambda m, p, y: m["nn"].dice_loss(p, y), [PROBS, LABELS01], (0,)),
    ("mean_iou", lambda m, p, l: m["nn"].mean_iou(p, l, 5),
     [np.array([[0, 1, 1], [4, 2, 2]], np.int32), np.array([[0, 1, 2], [4, 4, 2]], np.int32)], ()),
    ("hsigmoid_loss", lambda m, x, w, b, y: m["nn"].hsigmoid_loss(x, w, b, y, 6),
     [_x(4, 3), _x(5, 3), _x(5), np.array([0, 5, 2, 3], np.int32)], (0, 1, 2)),
    ("hsigmoid_loss_no_bias", lambda m, x, w, y: m["nn"].hsigmoid_loss(x, w, None, y, 2),
     [_x(4, 3), _x(1, 3), np.array([0, 1, 1, 0], np.int32)], (0, 1)),
    ("hsigmoid_loss_at_kink", lambda m, x, w, b, y: m["nn"].hsigmoid_loss(x, w, b, y, 6),
     [_x(4, 3), np.concatenate([np.zeros((3, 3), np.float32), _x(2, 3)]),
      np.float32([0, 0, 0, 0.5, -0.5]), np.array([0, 5, 2, 3], np.int32)], (0, 1, 2)),
    # 3-D
    ("conv3d", lambda m, x, w: m["nn3d"].conv3d(x, w), [VOL, _x(2, 2, 3, 3, 4)], (0, 1)),
    ("conv3d_stride_pad", lambda m, x, w: m["nn3d"].conv3d(x, w, 2, 1, 1), [VOL, _x(3, 3, 3, 3, 2)],
     (0, 1)),
    ("conv3d_same", lambda m, x, w: m["nn3d"].conv3d(x, w, (1, 2, 2), "SAME"),
     [VOL, _x(2, 3, 2, 3, 4)], (0, 1)),
    ("conv3d_groups_dilation", lambda m, x, w: m["nn3d"].conv3d(x, w, 1, "VALID", 2, 3),
     [VOL, _x(2, 2, 2, 1, 6)], (0, 1)),
    ("conv3d_transpose", lambda m, x, w: m["nn3d"].conv3d_transpose(x, w),
     [VOL, _x(2, 2, 2, 3, 4)], (0, 1)),
    ("conv3d_transpose_s2", lambda m, x, w: m["nn3d"].conv3d_transpose(x, w, 2, 1, 1),
     [VOL, _x(3, 3, 3, 3, 2)], (0, 1)),
    ("pool3d_max", lambda m, x: m["nn3d"].pool3d(x, 2, "max", 2), [VOL], (0,)),
    ("pool3d_max_pad", lambda m, x: m["nn3d"].pool3d(x, 3, "max", 2, 1), [VOL], (0,)),
    ("pool3d_avg_exclusive", lambda m, x: m["nn3d"].pool3d(x, 3, "avg", 2, 1), [VOL], (0,)),
    ("pool3d_avg_inclusive", lambda m, x: m["nn3d"].pool3d(x, 3, "avg", 2, 1, exclusive=False),
     [VOL], (0,)),
    ("pool3d_global", lambda m, x: m["nn3d"].pool3d(x, pool_type="avg", global_pooling=True),
     [VOL], (0,)),
    # vision
    ("image_resize_scale", lambda m, x: m["vision"].image_resize(x, scale=1.5), [IMG], (0,)),
    ("image_resize_half_pixel", lambda m, x: m["vision"].image_resize(x, (3, 5), align_corners=False),
     [IMG], (0,)),
    ("image_resize_nearest", lambda m, x: m["vision"].image_resize(x, (9, 3), resample="NEAREST"),
     [IMG], (0,)),
    ("image_resize_short", lambda m, x: m["vision"].image_resize_short(x, 4), [IMG], (0,)),
    ("roi_pool", lambda m, x, r, i: m["vision"].roi_pool(x, r, i, 2, 3, 0.5),
     [IMG, np.float32([[0, 0, 6, 6], [2, 4, 12, 10], [4, 2, 4, 2], [9, 9, 30, 30]]),
      np.array([0, 1, 1, 0], np.int32)], (0,)),
    ("im2sequence", lambda m, x: m["vision"].im2sequence(x, 2), [IMG], (0,)),
    ("im2sequence_stride_pad", lambda m, x: m["vision"].im2sequence(x, (3, 2), (2, 1), (1, 0)),
     [IMG], (0,)),
]


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _close(name, got, want, rtol, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.linalg.norm(got - want)
    assert err <= rtol * max(np.linalg.norm(want), floor), (name, err, np.linalg.norm(want))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax(case):
    name, fn, args, _ = case
    want = _flat(fn(J, *(jnp.asarray(a) for a in args)))
    got = _flat(fn(T, *(torch.from_numpy(np.array(a)) for a in args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.kind in "biu":
            assert str(g.dtype).replace("torch.", "") == w.dtype.name, (name, g.dtype)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            assert g.dtype == torch.float32, (name, g.dtype)
            _close(name, g.detach().numpy(), w, FWD_RTOL, FWD_FLOOR)


GRAD_CASES = [c for c in CASES if c[3]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradient_matches_jax(case):
    name, fn, args, argnums = case
    outs = _flat(fn(J, *(jnp.asarray(a) for a in args)))
    r = np.random.RandomState(5)
    cts = [np.asarray(r.randn(*np.shape(o)), np.float32) for o in outs]

    def j_loss(*xs):
        return sum(jnp.sum(o * c) for o, c in zip(_flat(fn(J, *xs)), cts))

    want = jax.grad(j_loss, argnums=argnums)(*(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(np.array(a)) for a in args]
    for i in argnums:
        ts[i].requires_grad_(True)
    loss = sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(_flat(fn(T, *ts)), cts))
    got = torch.autograd.grad(loss, [ts[i] for i in argnums])
    for i, g, w in zip(argnums, got, want):
        _close(f"{name} d/darg{i}", g.numpy(), w, GRAD_RTOL, 1e-8)


def test_every_new_function_is_held():
    ported_before = {"conv2d", "pool2d", "softmax", "cross_entropy", "softmax_with_cross_entropy",
                     "square_error_cost", "accuracy", "layer_norm", "embedding_lookup", "dropout",
                     "adaptive_pool2d", "batch_norm_train", "batch_norm_infer", "one_hot",
                     "label_smooth"}
    assert set(tn.__all__) == set(jn.__all__)
    held = {c[0] for c in CASES}
    for mod, names in (("nn", set(tn.__all__) - ported_before - {"nce_loss"}),
                       ("nn3d", set(t3.__all__)), ("vision", set(tv.__all__) - {"random_crop"})):
        for n in names:
            assert any(h == n or h.startswith(n + "_") for h in held), (mod, n)


def test_nce_loss_on_the_jax_package_samples():
    b, d, n_classes, s = 5, 4, 12, 3
    x, w, bias = _x(b, d), _x(n_classes, d), _x(n_classes)
    labels = np.array([1, 11, 0, 5, 5], np.int32)
    key = jax.random.PRNGKey(7)
    samples = np.asarray(jax.random.randint(key, (b, s), 0, n_classes))  # nce_loss's own draw
    want = jn.nce_loss(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(labels), s,
                       key, n_classes)
    gw = jax.grad(lambda xx, ww, bb: jnp.sum(jn.nce_loss(xx, ww, bb, jnp.asarray(labels), s, key,
                                                         n_classes)), (0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    got = tn.nce_loss(tx, tw, tb, torch.from_numpy(labels), s, None, n_classes,
                      samples=torch.from_numpy(samples))
    _close("nce", got.detach().numpy(), want, FWD_RTOL, FWD_FLOOR)
    for g, ww in zip(torch.autograd.grad(got.sum(), (tx, tw, tb)), gw):
        _close("nce grad", g.numpy(), ww, GRAD_RTOL, 1e-8)


def test_nce_loss_at_logit_zero_gives_the_jax_gradient():
    """Zero weights and biases, and as many noise samples as classes (the
    posterior correction log(k/n) is 0): every logit is exactly 0, where the
    JAX package's gradient is -label."""
    b, d, n_classes = 3, 4, 5
    x, w, bias = _x(b, d), np.zeros((n_classes, d), np.float32), np.zeros(n_classes, np.float32)
    labels = np.array([1, 4, 0], np.int32)
    key = jax.random.PRNGKey(2)
    samples = np.asarray(jax.random.randint(key, (b, n_classes), 0, n_classes))
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    want = jax.grad(lambda xx, ww, bb: jnp.sum(jn.nce_loss(xx, ww, bb, jnp.asarray(labels), n_classes,
                                                           key, n_classes)), (0, 1, 2))(*args)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    got = tn.nce_loss(tx, tw, tb, torch.from_numpy(labels), n_classes, None, n_classes,
                      samples=torch.from_numpy(samples))
    for g, ww in zip(torch.autograd.grad(got.sum(), (tx, tw, tb)), want):
        _close("nce at 0", g.numpy(), ww, GRAD_RTOL, 1e-8)


def test_mnist_net_on_a_blank_topped_batch_matches_jax_gradients():
    """The MNIST conv net at init on a batch whose top half is blank: its
    ReLUs and max pools sit on exact zeros and ties, and every parameter's
    gradient is the JAX package's within 1e-4 relative L2."""
    from paddle_tpu import backward as jbackward
    from paddle_tpu import models as jmodels
    from paddle_tpu_torch import backward as tbackward
    from paddle_tpu_torch import convert
    from paddle_tpu_torch import models as tmodels

    jspec, tspec = jmodels.get_model("mnist"), tmodels.get_model("mnist", device="cpu")
    images, labels = jspec.synth_batch(8, np.random.RandomState(0))
    images = np.asarray(images).copy()
    images[:, :14] = 0.0
    jvars = jspec.model.init(jax.random.PRNGKey(0), jnp.asarray(images), labels)
    params = convert.params_from_jax({n: np.asarray(a) for n, a in jvars.params.items()}, "cpu")
    _, (jgrads, _, _) = jax.jit(jbackward.append_backward(jspec.model, jnp.asarray(images), labels))(
        jvars.params)
    _, (tgrads, _, _) = tbackward.append_backward(
        tspec.model, torch.from_numpy(images), torch.from_numpy(np.asarray(labels)))(params)
    assert set(tgrads) == set(jgrads)
    for n, g in jgrads.items():
        _close(f"mnist d/d{n}", tgrads[n].numpy(), g, GRAD_RTOL, 1e-8)


def test_nce_sampler_is_uniform_over_the_classes():
    """nce_loss's noise ids are uniform draws from its generator: the loss
    equals the loss given those draws, and the draws cover the classes
    evenly."""
    n_classes, s = 6, 3000
    x, w, b = (torch.from_numpy(a) for a in (_x(2, 3), _x(n_classes, 3), _x(n_classes)))
    labels = torch.tensor([0, 4])
    out = tn.nce_loss(x, w, b, labels, s, torch.Generator().manual_seed(3), n_classes)
    draws = torch.randint(0, n_classes, (2, s), generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, tn.nce_loss(x, w, b, labels, s, None, n_classes, samples=draws))
    freq = np.bincount(draws.reshape(-1).numpy(), minlength=n_classes) / draws.numel()
    np.testing.assert_allclose(freq, 1.0 / n_classes, atol=0.02)


def test_random_crop_offsets_and_contents():
    x = torch.arange(2 * 5 * 6 * 2, dtype=torch.float32).reshape(2, 5, 6, 2)
    seen = set()
    for seed in range(40):
        out = tv.random_crop(x, (3, 4), torch.Generator().manual_seed(seed))
        assert tuple(out.shape) == (2, 3, 4, 2)
        for i in range(2):
            y0 = int((out[i, 0, 0, 0] - x[i, 0, 0, 0]) // 12)
            x0 = int((out[i, 0, 0, 0] - x[i, 0, 0, 0]) % 12) // 2
            assert 0 <= y0 <= 2 and 0 <= x0 <= 2
            assert torch.equal(out[i], x[i, y0:y0 + 3, x0:x0 + 4])
            seen.add((y0, x0))
    assert len(seen) == 9  # every offset of the 3 x 3 range was drawn
    j = jv.random_crop(jnp.asarray(x.numpy()), (3, 4), jax.random.PRNGKey(0))
    assert j.shape == (2, 3, 4, 2)


def test_transposed_conv_output_padding_beyond_the_stride_raises():
    with pytest.raises(ValueError, match="output_padding"):
        tn.conv2d_transpose(torch.zeros(1, 3, 3, 2), torch.zeros(3, 3, 2, 2), 2, 0, 2)

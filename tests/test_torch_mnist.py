"""The MNIST conv net's ops and model in the port against the JAX package,
on the CPU, and the bundled-digits book test through the port's Trainer.

Tolerances: the ops in f32 at rtol 1e-5, atol 1e-5 (``conv2d``, ``pool2d``
max and avg, ``softmax``, ``cross_entropy``, ``softmax_with_cross_entropy``
and its gradient, ``accuracy``) — products summed in other orders by XLA
and PyTorch. ``cnn_model``'s logits on identical weights at atol 1e-4 (two
5×5 convolutions and a 2450-wide fc accumulate more terms), its loss at
rtol 1e-5 and its gradients at rtol 1e-4, atol 1e-6. The digits net
(``tests/test_book.py:357``): 30 epochs through the port's Trainer, then
``evaluate()`` over all 359 test samples, accuracy > 0.90.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu import backward as jbackward
from paddle_tpu import models as jmodels
from paddle_tpu.ops import nn as jnn
from paddle_tpu_torch import backward as tbackward
from paddle_tpu_torch import convert
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import nets, reader
from paddle_tpu_torch.dataset import digits as ds_digits
from paddle_tpu_torch.ops import nn as tnn
from paddle_tpu_torch.trainer import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("kw, wshape", [
    (dict(), (3, 3, 4, 6)),
    (dict(stride=2, padding=1), (3, 3, 4, 6)),
    (dict(stride=(2, 1), padding=(0, 2)), (5, 3, 4, 6)),
    (dict(padding="SAME", stride=2), (5, 5, 4, 6)),
    (dict(padding="SAME", dilation=2), (3, 3, 4, 6)),
    (dict(padding="VALID", stride=3), (4, 4, 4, 6)),
    (dict(padding=1, groups=2), (3, 3, 2, 6)),
], ids=["plain", "stride2_pad1", "asym", "same_s2", "same_dil2", "valid_s3", "groups2"])
def test_conv2d_matches_jax(kw, wshape):
    x, w = _rand(2, 11, 10, 4), _rand(*wshape, seed=1)
    _close(tnn.conv2d(torch.from_numpy(x), torch.from_numpy(w), **kw), jnn.conv2d(x, w, **kw))


@pytest.mark.parametrize("kw", [
    dict(pool_size=2, pool_type="max", pool_stride=2),
    dict(pool_size=3, pool_type="max", pool_stride=2, pool_padding=1),
    dict(pool_size=3, pool_type="max", pool_stride=2, ceil_mode=True),
    dict(pool_size=2, pool_type="avg", pool_stride=2),
    dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1),
    dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1, exclusive=False),
    dict(pool_size=3, pool_type="avg", pool_stride=2, ceil_mode=True),
    dict(pool_type="avg", global_pooling=True),
], ids=["max2", "max3_pad1", "max3_ceil", "avg2", "avg3_pad1", "avg3_pad1_inclusive",
        "avg3_ceil", "avg_global"])
def test_pool2d_matches_jax(kw):
    x = _rand(2, 9, 10, 3)
    _close(tnn.pool2d(torch.from_numpy(x), **kw), jnn.pool2d(x, **kw))


def test_softmax_losses_and_accuracy_match_jax():
    logits = _rand(6, 10) * 3
    labels = np.array([0, 3, 9, 3, 5, -100], np.int64)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    _close(tnn.softmax(tl), jnn.softmax(logits))
    for lab in (labels, labels[:, None]):
        _close(tnn.softmax_with_cross_entropy(tl, torch.from_numpy(lab)),
               jnn.softmax_with_cross_entropy(logits, lab))
        probs = np.asarray(jnn.softmax(logits))
        _close(tnn.cross_entropy(torch.from_numpy(probs), torch.from_numpy(lab)),
               jnn.cross_entropy(probs, lab))
    soft = np.asarray(jnn.softmax(_rand(6, 10, seed=2)))
    _close(tnn.softmax_with_cross_entropy(tl, torch.from_numpy(soft), soft_label=True),
           jnn.softmax_with_cross_entropy(logits, soft, soft_label=True))
    _, sm = tnn.softmax_with_cross_entropy(tl, tlab, return_softmax=True)
    _close(sm, jnn.softmax(logits))
    # the gradient of the mean loss with respect to the logits
    x = tl.clone().requires_grad_()
    tnn.softmax_with_cross_entropy(x, tlab).mean().backward()
    jg = jax.grad(lambda z: jnn.softmax_with_cross_entropy(z, labels).mean())(logits)
    _close(x.grad, jg)
    ok = labels[labels >= 0]
    for k in (1, 3):
        _close(tnn.accuracy(tl[:5], torch.from_numpy(ok)), jnn.accuracy(logits[:5], ok))
        _close(tnn.accuracy(tl[:5], torch.from_numpy(ok[:, None]), k=k),
               jnn.accuracy(logits[:5], ok[:, None], k=k))


def test_cnn_model_matches_jax_on_identical_weights():
    jspec = jmodels.get_model("mnist")
    tspec = tmodels.get_model("mnist", device="cpu")
    images, labels = jspec.synth_batch(8, np.random.RandomState(0))
    jvars = jspec.model.init(jax.random.PRNGKey(0), images, labels)
    tparams = convert.params_from_jax({n: np.asarray(a) for n, a in jvars.params.items()}, "cpu")
    timg, tlab = torch.from_numpy(np.asarray(images)), torch.from_numpy(np.asarray(labels))
    tvars = tspec.model.init(0, timg, tlab, device="cpu")
    assert set(tvars.params) == set(jvars.params)
    assert all(tuple(tvars.params[n].shape) == jvars.params[n].shape for n in jvars.params)
    (tloss, tacc, tlogits), _ = tspec.model.apply(tparams, timg, tlab)
    (jloss, jacc, jlogits), _ = jspec.model.apply(jvars, images, labels)
    _close(tlogits, jlogits, rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tacc) == float(jacc)
    _, (jgrads, _, _) = jax.jit(jbackward.append_backward(jspec.model, images, labels))(jvars.params)
    _, (tgrads, _, _) = tbackward.append_backward(tspec.model, timg, tlab)(tparams)
    for n, g in jgrads.items():
        _close(tgrads[n], g, rtol=1e-4, atol=1e-6)


def test_get_model_mnist_trains_through_trainer():
    spec = tmodels.get_model("mnist", device="cpu")
    batch = spec.synth_batch(16, np.random.RandomState(0))
    assert batch[0].device.type == "cpu" and batch[1].dtype == torch.int32
    losses = []
    t = Trainer(lambda: spec.model, spec.optimizer, place="cpu")
    t.train(num_epochs=1, reader=lambda: iter([batch] * 4),
            event_handler=lambda ev: losses.append(ev.metrics)
            if type(ev).__name__ == "EndStepEvent" else None)
    assert len(losses) == 4 and losses[-1] < losses[0]


def test_recognize_digits_real_data_to_accuracy():
    """Port of ``tests/test_book.py:357``: the digits net trained through
    the port's Trainer, scored with evaluate() over all 359 test samples."""
    if not ds_digits.available():
        pytest.skip("scikit-learn (the bundled digits) cannot be imported")

    def net(img, label):
        img = img.reshape(img.shape[0], 28, 28, 1)
        conv = nets.simple_img_conv_pool(img, num_filters=16, filter_size=5, pool_size=2,
                                         pool_stride=2, act="relu")
        logits = pt.layers.fc(conv.reshape(img.shape[0], -1), size=10, name="clf")
        loss = pt.layers.softmax_with_cross_entropy(logits, label).mean()
        return loss, logits

    train_r = reader.stack_batch(
        lambda: ((im, np.int64(lb)) for im, lb in ds_digits.train_as_mnist()()), 64)

    def lab2d(b):  # labels as [B,1] int64 (softmax_with_cross_entropy shape)
        return b[0].astype(np.float32), b[1].reshape(-1, 1)

    tr = Trainer(lambda: pt.build(net, name="digits_book"),
                 lambda: pt.optimizer.Adam(learning_rate=1e-3), place="cpu")
    tr.train(num_epochs=30, reader=lambda: (lab2d(b) for b in train_r()))

    test_r = reader.stack_batch(
        lambda: ((im, np.int64(lb)) for im, lb in ds_digits.test_as_mnist()()),
        128, drop_last=False)
    n_test = sum(len(b[0]) for b in test_r())
    assert n_test == 359
    acc = tr.evaluate(lambda: (lab2d(b) for b in test_r()),
                      lambda out, x, y: out[1].argmax(-1).numpy() == y[:, 0])
    assert acc > 0.90, acc

"""The conv zoo in the port against the JAX package, on the CPU: batch norm
(train, infer, the moving statistics), adaptive pooling, dropout's
statistics, ResNet, SE-ResNeXt and VGG-16 (``get_model`` names, parameter
and state paths, forward passes and training steps).

Weights come from the port's ``init`` (seeded) and go to the JAX package as
numpy arrays; inputs come from the specs' numpy-seeded ``synth_batch``.

Tolerances, f32 (``use_bf16_compute`` off):
- batch norm's output and moving statistics at 1e-6 absolute on values of
  unit scale (f32 means and variances over at most 4·6·5 values, summed in
  other orders: a few f32 ulps).
- adaptive pooling at 1e-6 absolute (the same bin sums and maxima).
- the training step of ResNet-20 (cifar10) on batch 4: loss at 1e-5
  relative, each parameter's gradient at 1e-4 relative L2, the new BN
  state at 1e-5 absolute, the Momentum update at 1e-5 absolute. Twenty
  convolutions and BNs sum in other orders in XLA and PyTorch; this step's
  gradients move by 2e-6 when the input moves by 1e-7
  (``tools/torch_conv_zoo_probe.py``), so 1e-4 has room.
- ResNet-50 and SE-ResNeXt-50 forwards, batch 2: logits at 1e-4 relative
  L2 and the loss at 1e-5 relative in eval mode (32×32); in train mode at
  64×64, logits and the new BN state at 1e-3 relative L2. Train mode
  normalizes with batch statistics: at 32×32 the last stage is 1×1, its
  BNs normalize over N·H·W = 2 values, and the port's own train-mode
  logits move by 0.55 (ResNet-50) and 0.33 (SE-ResNeXt-50) relative L2
  when the input moves by 1e-7, so no tolerance means anything there; at
  64×64 they move by 1.2e-4 and 1.9e-5 (``tools/torch_conv_zoo_probe.py``).
- VGG-16's training step (cifar10, batch 4): loss at 1e-5 relative;
  gradients at 5e-2 relative L2, with a floor of 1e-2 of the largest
  gradient's norm. The port's own f32 gradients of this step move by
  4.5e-3 relative L2 over all of them when the input moves by 1e-7 (ReLU's
  kinks through train-mode BN; ``tools/torch_conv_zoo_probe.py``), and
  single parameters by more: the scale both packages' f32 rounding
  reaches, which 5e-2 per parameter leaves room over; the conv
  biases that feed a train-mode BN have zero gradient in exact arithmetic
  (BN subtracts the batch mean), hence the floor. The two packages'
  random streams differ, so dropout is replaced by the identity in both
  packages for this test (``monkeypatch`` on both ``layers.dropout``), and
  likewise for SE-ResNeXt's train-mode forward (its head has a dropout).
- bf16 compute (``use_bf16_compute`` on in both): ResNet-20's loss at 2e-2
  relative; bf16 operands round at 2^-8 in every product of both packages.
- dropout's statistics (the streams cannot be matched): at 1M elements the
  kept share is within 1% of 1 - p and the mean within 1% of the input's
  under ``upscale_in_train``; eval (``is_test``) and p = 0 are the identity.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import backward as jbackward
from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.ops import nn as jnn
import paddle_tpu_torch as pt
from paddle_tpu_torch import backward as tbackward
from paddle_tpu_torch import convert
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops import nn as tnn


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture
def set_both_flags():
    names = ("use_bf16_compute",)
    saved_j = {f: getattr(jconfig.flags(), f) for f in names}
    saved_t = {f: getattr(tconfig.flags(), f) for f in names}

    def set_(**kw):
        jconfig.set_flags(**kw)
        tconfig.set_flags(**kw)

    yield set_
    jconfig.set_flags(**saved_j)
    tconfig.set_flags(**saved_t)


# ----------------------------------------------------------------- batch norm
@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (4, 1, 1, 8)], ids=["nhwc", "fc_n4"])
def test_batch_norm_train_and_infer_match_jax(shape):
    x = _rand(*shape) + 1
    c = shape[-1]
    scale, bias = _rand(c, seed=1), _rand(c, seed=2)
    mm, mv = _rand(c, seed=3), np.abs(_rand(c, seed=4)) + 0.5
    j = jnn.batch_norm_train(x, scale, bias, mm, mv, 0.9, 1e-5)
    t = tnn.batch_norm_train(*(torch.from_numpy(a) for a in (x, scale, bias, mm, mv)), 0.9, 1e-5)
    for a, b in zip(t, j):  # y, new mean, new var (biased: n/(n-1) at N=4 is 4/3), batch stats
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert not any(v.requires_grad for v in t[1:])
    np.testing.assert_allclose(
        tnn.batch_norm_infer(*(torch.from_numpy(a) for a in (x, scale, bias, mm, mv))).numpy(),
        np.asarray(jnn.batch_norm_infer(x, scale, bias, mm, mv)), rtol=0, atol=1e-6)


def test_batch_norm_fused_formula_matches_plain():
    """The card's formula (PyTorch's fused batch norm on the channels-last
    view, the variance from its saved inverse std) on CPU tensors, against
    the plain composition, forward and gradients."""
    x = torch.from_numpy(_rand(4, 6, 5, 3) * 3 + 1)
    scale, bias = torch.from_numpy(_rand(3, seed=1)), torch.from_numpy(_rand(3, seed=2))
    g = torch.from_numpy(_rand(4, 6, 5, 3, seed=5))
    outs = []
    for fn in (tnn._batch_norm_stats_fused, tnn._batch_norm_stats_plain):
        xs, ss = x.clone().requires_grad_(), scale.clone().requires_grad_()
        y, mean, var = fn(xs, ss, bias, 1e-5)
        (y * g).sum().backward()
        outs.append((y.detach(), mean, var, xs.grad, ss.grad))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-5)


def test_batch_norm_layer_state_names_and_nchw():
    def net(x):
        h = pt.layers.batch_norm(x, data_format="NCHW")
        return pt.layers.batch_norm(h, act="relu", name="second", data_format="NCHW")

    x = torch.from_numpy(_rand(4, 3, 5, 5))
    model = pt.build(net)
    v = model.init(0, x, device="cpu")
    assert sorted(v.params) == ["batch_norm/bias", "batch_norm/scale", "second/bias", "second/scale"]
    assert sorted(v.state) == ["batch_norm/moving_mean", "batch_norm/moving_variance",
                               "second/moving_mean", "second/moving_variance"]
    jmodel = jpt.build(lambda x: jpt.layers.batch_norm(
        jpt.layers.batch_norm(x, data_format="NCHW"), act="relu", name="second", data_format="NCHW"))
    jv = JVariables(convert.params_to_numpy(v.params), convert.params_to_numpy(v.state))
    for train in (True, False):
        out, new = model.apply(v, x, is_train=train)
        jout, jnew = jmodel.apply(jv, x.numpy(), is_train=train)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
        assert sorted(new) == sorted(jnew)
        for k in new:
            np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), rtol=0, atol=1e-6)
        assert not any(t.requires_grad for t in new.values())
    # apply with a graph: the new state still carries none
    p = {k: t.clone().requires_grad_() for k, t in v.params.items()}
    _, new = model.apply(pt.framework.Variables(p, v.state), x, is_train=True)
    assert all(t.grad_fn is None for t in new.values())


# ------------------------------------------------------------ adaptive pooling
@pytest.mark.parametrize("hw, out, kind", [
    ((8, 6), (4, 3), "avg"), ((8, 6), (4, 3), "max"),
    ((7, 5), (3, 2), "avg"), ((7, 5), (3, 2), "max"),
], ids=["avg_divisible", "max_divisible", "avg_nondivisible", "max_nondivisible"])
def test_adaptive_pool2d_matches_jax(hw, out, kind):
    x = _rand(2, *hw, 3)
    np.testing.assert_allclose(tnn.adaptive_pool2d(torch.from_numpy(x), out, kind).numpy(),
                               np.asarray(jnn.adaptive_pool2d(x, out, kind)), rtol=0, atol=1e-6)


# -------------------------------------------------------------------- dropout
def test_dropout_statistics_and_identities():
    x = torch.full((1000, 1000), 2.0)
    gen = torch.Generator().manual_seed(0)
    for p in (0.2, 0.5):
        y = tnn.dropout(x, p, generator=gen)
        kept = float((y != 0).float().mean())
        assert abs(kept - (1 - p)) <= 0.01 * (1 - p), (p, kept)
        assert abs(float(y.mean()) - 2.0) <= 0.01 * 2.0, (p, float(y.mean()))
        assert torch.all((y == 0) | (y == 2.0 / (1 - p)))
    assert tnn.dropout(x, 0.5, is_test=True) is x
    assert tnn.dropout(x, 0.0) is x
    np.testing.assert_allclose(tnn.dropout(x, 0.5, is_test=True, upscale_in_train=False).numpy(), 1.0)


def test_dropout_layer_needs_rng_in_training():
    fc = pt.build(lambda x: pt.layers.dropout(pt.layers.fc(x, 2), 0.5))
    x = torch.ones(4, 8)
    params = fc.init(0, x, device="cpu").params  # init draws nothing
    params = {"fc/w": torch.ones(8, 2), "fc/b": torch.zeros(2)}
    with pytest.raises(EnforceError, match="pass rng="):
        fc.apply(params, x, is_train=True)
    out, _ = fc.apply(params, x, is_train=True, rng=torch.Generator().manual_seed(0))
    assert set(np.unique(out.numpy())) <= {0.0, 16.0}
    out, _ = fc.apply(params, x, is_train=False)
    np.testing.assert_allclose(out.numpy(), 8.0)


# --------------------------------------------------------------------- models
def _init(name, bs, **kw):
    """The port's spec and init (seed 0) on the CPU, the same variables as
    the JAX package's, and one numpy-seeded batch."""
    ts = tmodels.get_model(name, device="cpu", **kw)
    x, y = ts.synth_batch(bs, np.random.RandomState(0))
    tv = ts.model.init(0, x, y, device="cpu")
    jv = JVariables(convert.params_to_numpy(tv.params), convert.params_to_numpy(tv.state))
    return ts, jmodels.get_model(name, **kw), tv, jv, x, y


@pytest.mark.parametrize("name, kw", [
    ("resnet", dict(dataset="cifar10", depth=20)),
    ("resnet", dict(dataset="flowers", depth=50, image_size=32)),
    ("se_resnext", dict(image_size=32)),
    ("vgg", dict(dataset="cifar10")),
], ids=["resnet20_cifar10", "resnet50", "se_resnext50", "vgg16"])
def test_get_model_names_and_shapes_match_jax(name, kw):
    ts = tmodels.get_model(name, device="cpu", **kw)
    js = jmodels.get_model(name, **kw)
    x, y = ts.synth_batch(2, np.random.RandomState(0))
    tv = ts.model.init(0, x, y, device="cpu")
    jv = jax.eval_shape(lambda: js.model.init(jax.random.PRNGKey(0), x.numpy(), y.numpy()))
    for t, j in ((tv.params, jv.params), (tv.state, jv.state)):
        assert sorted(t) == sorted(j)
        for k in t:
            assert tuple(t[k].shape) == tuple(j[k].shape), k
            assert t[k].dtype == torch.float32
    assert ts.name == js.name and ts.unit == js.unit
    assert {k: v for k, v in ts.extra.items() if k != "device"} == js.extra


def test_resnet20_minimize_step_matches_jax():
    ts, js, tv, jv, x, y = _init("resnet", 4, dataset="cifar10", depth=20)
    jrun = jax.jit(lambda p, s, x, y: jbackward.append_backward(js.model, x, y, state=s)(p))
    jloss, (jg, jstate, _) = jrun(jv.params, jv.state, x.numpy(), y.numpy())
    opt = ts.optimizer()
    out = opt.minimize(ts.model)(tv, opt.create_state(tv.params), x, y)
    np.testing.assert_allclose(float(out.loss), float(jloss), rtol=1e-5)
    _, (tg, _, _) = tbackward.append_backward(ts.model, x, y, state=tv.state)(tv.params)
    worst = max((_rel_l2(tg[k].numpy(), jg[k]), k) for k in jg)
    assert worst[0] <= 1e-4, worst
    for k in jstate:
        np.testing.assert_allclose(out.variables.state[k].numpy(), np.asarray(jstate[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    # the update is the spec's Momentum on those gradients
    jopt = js.optimizer()
    jnew, _ = jopt.apply_gradients(jv.params, jg, jopt.create_state(jv.params), js.model.param_info)
    for k in jnew:
        np.testing.assert_allclose(out.variables.params[k].numpy(), np.asarray(jnew[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name, kw", [
    ("resnet", dict(dataset="flowers", depth=50)),
    ("se_resnext", dict()),
], ids=["resnet50", "se_resnext50"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(name, kw, train, monkeypatch):
    if train:  # SE-ResNeXt's head has a dropout: identity in both packages
        monkeypatch.setattr(pt.layers, "dropout", lambda x, *a, **k: x)
        monkeypatch.setattr(jpt.layers, "dropout", lambda x, *a, **k: x)
    ts, js, tv, jv, x, y = _init(name, 2, image_size=64 if train else 32, **kw)
    (tloss, _, tlogits), tnew = ts.model.apply(tv, x, y, is_train=train)
    (jloss, _, jlogits), jnew = js.model.apply(jv, x.numpy(), y.numpy(), is_train=train)
    assert _rel_l2(tlogits.detach().numpy(), jlogits) <= (1e-3 if train else 1e-4)
    if not train:
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert sorted(tnew) == sorted(jnew)
    if train:
        worst = max(_rel_l2(tnew[k].numpy(), jnew[k]) for k in jnew)
        assert worst <= 1e-3, worst


def test_vgg16_train_step_matches_jax_with_dropout_as_identity(monkeypatch):
    monkeypatch.setattr(pt.layers, "dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(jpt.layers, "dropout", lambda x, *a, **k: x)
    ts, js, tv, jv, x, y = _init("vgg", 4, dataset="cifar10")
    jrun = jax.jit(lambda p, s, x, y: jbackward.append_backward(js.model, x, y, state=s)(p))
    jloss, (jg, jstate, _) = jrun(jv.params, jv.state, x.numpy(), y.numpy())
    tloss, (tg, tstate, _) = tbackward.append_backward(ts.model, x, y, state=tv.state)(tv.params)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    floor = 1e-2 * max(np.linalg.norm(np.asarray(g)) for g in jg.values())
    worst = max((float(np.linalg.norm(tg[k].numpy() - np.asarray(jg[k]))
                       / max(np.linalg.norm(np.asarray(jg[k])), floor)), k) for k in jg)
    assert worst[0] <= 5e-2, worst
    # the head's BN on the [B, 1, 1, 512] fc output: N = 4, biased variance
    k = "batch_norm/moving_variance"
    np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), rtol=1e-5, atol=1e-6)
    opt = ts.optimizer()
    out = opt.minimize(ts.model)(tv, opt.create_state(tv.params), x, y)
    assert torch.isfinite(out.loss) and out.variables.state.keys() == tv.state.keys()


def test_resnet20_bf16_compute_loss_matches_jax(set_both_flags):
    set_both_flags(use_bf16_compute=True)
    ts, js, tv, jv, x, y = _init("resnet", 4, dataset="cifar10", depth=20)
    (tloss, _, _), _ = ts.model.apply(tv, x, y, is_train=True)
    (jloss, _, _), _ = js.model.apply(jv, x.numpy(), y.numpy(), is_train=True)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


def test_se_resnext_dropout_trains_with_rng():
    """SE-ResNeXt's training step with its dropout on: the rng is needed,
    the loss is finite and a seeded generator repeats the step exactly."""
    ts = tmodels.get_model("se_resnext", image_size=32, device="cpu")
    x, y = ts.synth_batch(2, np.random.RandomState(0))
    tv = ts.model.init(0, x, y, device="cpu")
    opt = ts.optimizer()
    step = opt.minimize(ts.model)
    with pytest.raises(EnforceError, match="pass rng="):
        step(tv, opt.create_state(tv.params), x, y)
    a = step(tv, opt.create_state(tv.params), x, y, rng=torch.Generator().manual_seed(3))
    b = step(tv, opt.create_state(tv.params), x, y, rng=torch.Generator().manual_seed(3))
    assert torch.isfinite(a.loss) and float(a.loss) == float(b.loss)


def test_trainer_passes_no_rng_so_dropout_raises():
    """As in the JAX package (its Trainer gives the step no rng), a model
    with training-mode dropout raises through ``Trainer.train``."""
    from paddle_tpu_torch.trainer import Trainer

    def net(x, y):
        h = pt.layers.dropout(pt.layers.fc(x, 4), dropout_prob=0.5)
        return torch.mean(pt.ops.nn.square_error_cost(pt.layers.fc(h, 1), y))

    rng = np.random.RandomState(0)
    batch = (rng.rand(4, 3).astype(np.float32), rng.rand(4, 1).astype(np.float32))
    trainer = Trainer(lambda: net, lambda: pt.optimizer.SGD(learning_rate=0.1), place="cpu")
    with pytest.raises(EnforceError, match="pass rng="):
        trainer.train(num_epochs=1, reader=lambda: iter([batch]))

"""The port's mixed-precision transpiler (``paddle_tpu_torch.transpiler.amp``)
against the JAX package's, on the CPU, mirroring ``tests/test_transpiler.py``'s
amp cases: ``cast_params``, a bf16 ``amp_minimize`` step, and an overflowing
step under dynamic loss scaling that is skipped while the scale backs off.

Tolerances: the bf16 step's loss at 2e-3 relative and its updated f32
parameters at 1e-5 absolute (bf16 operands round at 2^-8 in both packages'
products, and Adam at lr 0.01 moves each parameter by at most ~lr; the two
packages round the same operands but sum in other orders). The loss-scaled
step: scale, finite flag and the skipped update exactly.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.transpiler import amp as jamp
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.framework import Variables
from paddle_tpu_torch.transpiler import DynamicLossScale, amp_minimize, cast_params


def _mlp(pkg, mean, sq):
    def net(x, y):
        h = pkg.layers.fc(x, size=16, act="relu")
        pred = pkg.layers.fc(h, size=1)
        return mean(sq(pred, y))

    return pkg.build(net)


def _models():
    return (_mlp(pt, torch.mean, pt.ops.nn.square_error_cost),
            _mlp(jpt, jnp.mean, jpt.ops.nn.square_error_cost))


def _data(n):
    rng = np.random.RandomState(0)
    return rng.randn(n, 4).astype(np.float32), rng.randn(n, 1).astype(np.float32)


def test_cast_params():
    tree = {"w": torch.ones((2, 2)), "i": torch.ones((2,), dtype=torch.int32),
            "nested": {"s": torch.zeros(3)}}
    out = cast_params(tree, "bfloat16")
    assert out["w"].dtype == torch.bfloat16 and out["nested"]["s"].dtype == torch.bfloat16
    assert out["i"].dtype == torch.int32  # non-float untouched
    j = jamp.cast_params({"w": jnp.ones((2, 2)), "i": jnp.ones((2,), jnp.int32)}, "bfloat16")
    assert str(j["w"].dtype) == "bfloat16" and str(j["i"].dtype) == "int32"


def test_amp_minimize_bf16_step_matches_jax():
    tmodel, jmodel = _models()
    x, y = _data(8)
    tv = tmodel.init(0, torch.from_numpy(x), torch.from_numpy(y), device="cpu")
    jparams = convert.params_to_numpy(tv.params)
    topt, jopt = pt.optimizer.Adam(learning_rate=0.01), jpt.optimizer.Adam(learning_rate=0.01)
    tstep = amp_minimize(topt, tmodel, compute_dtype="bfloat16")
    jmodel.init(0, x, y)  # records param_info, as the JAX step reads it
    jstep = jax.jit(jamp.amp_minimize(jopt, jmodel, compute_dtype="bfloat16"))
    tout = tstep(tv, topt.create_state(tv.params), None, torch.from_numpy(x), torch.from_numpy(y))
    jout = jstep(JVariables(jparams, {}), jopt.create_state(jparams), None, x, y)
    np.testing.assert_allclose(float(tout.loss), float(jout.loss), rtol=2e-3)
    assert bool(tout.grads_finite) and bool(jout.grads_finite)
    for k, v in tout.variables.params.items():
        assert v.dtype == torch.float32  # master weights stay f32
        np.testing.assert_allclose(v.numpy(), np.asarray(jout.variables.params[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    # training goes on: ten steps lower the loss
    v, o, losses = tout.variables, tout.opt_state, []
    for _ in range(10):
        out = tstep(v, o, None, torch.from_numpy(x), torch.from_numpy(y))
        v, o = out.variables, out.opt_state
        losses.append(float(out.loss))
    assert losses[-1] < losses[0]


def test_amp_dynamic_loss_scaling_skips_overflow():
    tmodel, jmodel = _models()
    x, y = _data(4)
    tv = tmodel.init(0, torch.from_numpy(x), torch.from_numpy(y), device="cpu")
    opt = pt.optimizer.SGD(learning_rate=0.1)
    opt_state = opt.create_state(tv.params)
    scale = DynamicLossScale.create(initial=2.0 ** 15, device="cpu")
    step = amp_minimize(opt, tmodel, use_loss_scaling=True)
    out = step(tv, opt_state, scale, torch.from_numpy(x), torch.from_numpy(y))
    assert bool(out.grads_finite)
    assert float(out.loss_scale.scale) == 2.0 ** 15  # unchanged below the interval
    assert out.opt_state.step == 1 and int(out.loss_scale.good_steps) == 1

    # poison the input: non-finite gradients, the update skipped, the scale halved
    bad_x = x.copy()
    bad_x[0, 0] = np.inf
    out2 = step(tv, opt_state, scale, torch.from_numpy(bad_x), torch.from_numpy(y))
    assert not bool(out2.grads_finite)
    for k in tv.params:
        assert torch.equal(out2.variables.params[k], tv.params[k])
    assert out2.opt_state.step == 0
    assert float(out2.loss_scale.scale) == 2.0 ** 14 and int(out2.loss_scale.good_steps) == 0

    # the same poisoned step in the JAX package
    jparams = convert.params_to_numpy(tv.params)
    jmodel.init(0, x, y)
    jopt = jpt.optimizer.SGD(learning_rate=0.1)
    jout = jax.jit(jamp.amp_minimize(jopt, jmodel, use_loss_scaling=True))(
        JVariables(jparams, {}), jopt.create_state(jparams), jamp.DynamicLossScale.create(2.0 ** 15),
        bad_x, y)
    assert not bool(jout.grads_finite)
    assert float(jout.loss_scale.scale) == float(out2.loss_scale.scale)


def test_loss_scale_grows_after_the_interval():
    scale = DynamicLossScale.create(initial=4.0, device="cpu")
    yes, no = torch.tensor(True), torch.tensor(False)
    for _ in range(3):
        scale = scale.update(yes, growth_interval=3)
    assert float(scale.scale) == 8.0 and int(scale.good_steps) == 0
    scale = scale.update(no)
    assert float(scale.scale) == 4.0
    j = jamp.DynamicLossScale.create(4.0)
    for _ in range(3):
        j = j.update(jnp.asarray(True), growth_interval=3)
    assert float(j.scale) == 8.0
    low = DynamicLossScale.create(initial=1.0, device="cpu").update(no)
    assert float(low.scale) == 1.0  # clamped to [1, 2^24]


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float16"])
def test_amp_minimize_threads_bn_state(compute_dtype):
    """A model with BatchNorm state: the state comes back updated and f32."""
    def net(x, y):
        h = pt.layers.batch_norm(pt.layers.conv2d(x, 4, 3, padding=1), act="relu")
        return torch.mean(pt.ops.nn.square_error_cost(pt.layers.fc(h, 1), y))

    model = pt.build(net)
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 6, 6, 2).astype(np.float32))
    y = torch.ones(4, 1)
    v = model.init(0, x, y, device="cpu")
    opt = pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
    out = amp_minimize(opt, model, compute_dtype=compute_dtype)(
        v, opt.create_state(v.params), None, x, y)
    assert isinstance(out.variables, Variables) and sorted(out.variables.state) == sorted(v.state)
    for k, t in out.variables.state.items():
        assert t.dtype == torch.float32 and not torch.equal(t, v.state[k])

"""The port's ``DataParallel`` on two gloo ranks (CPU) against the JAX
package's ``DataParallel`` at ``make_mesh(data=2)`` and against the port's
single-device step on the global batch, over three steps, for an MLP, the
LM (unragged, and ragged through ``seq_lens``), a small ResNet with
BatchNorm (its moving statistics too) and a small NMT Transformer; then
ZeRO-1 against the plain step, ``step_ragged`` against the single-device
step, and ``minimize(axis_name=)`` against the JAX package's pmap form.

Every case runs in one spawn of two ranks (``torch_parallel_cases.py``;
about 4 s to start), from the same numpy-seeded batch and weights as the
JAX side.

Tolerances, f32 (those of ``tests/test_torch_train_step.py:8-14``): losses
at rtol 1e-5; parameters after three steps at atol 1e-4 (parameters
whose gradients are rounding noise — the attention k biases, and the fc
bias feeding a train-mode BN — at the sum of the three scheduled rates,
what three Adam steps can move them); optimizer slots at rtol 1e-4, atol
1e-7 (not those parameters' slots); BN moving statistics at atol 1e-5 and, for the ResNet, its
Momentum velocities (sums of gradients) at the 1e-4 relative L2 per
parameter that ``test_torch_conv_zoo.py`` holds ResNet-20's gradients to
(twenty convolutions and BNs sum in other orders; single elements near 0
move by more than rtol 1e-4).
The two ranks' parameters must be bit-equal (no replica drift), and ZeRO-1
must equal the plain step bit for bit (its update is elementwise).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import torch_parallel_cases as cases
from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.parallel import DataParallel as JDataParallel
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.framework import Variables
from paddle_tpu_torch.parallel import launch

MODELS = ("mlp", "lm", "lm_ragged", "resnet_bn", "nmt")


@pytest.fixture(scope="module", autouse=True)
def f32_flags():
    names = ("use_flash_attention", "use_bf16_compute")
    saved = ({f: getattr(jconfig.flags(), f) for f in names},
             {f: getattr(tconfig.flags(), f) for f in names})
    jconfig.set_flags(use_flash_attention=False, use_bf16_compute=False)
    tconfig.set_flags(use_flash_attention=False, use_bf16_compute=False)
    yield
    jconfig.set_flags(**saved[0])
    tconfig.set_flags(**saved[1])


def _jax_model(name):
    if name == "mlp":
        return jpt.build(cases.mlp_net(jpt.layers, jpt.ops, jnp.mean), name="mlp"), \
            lambda: jpt.optimizer.Adam(cases.MLP_LR)
    if name == "bn":
        return jpt.build(cases.bn_net(jpt.layers, jpt.ops, jnp.mean), name="bn_net"), \
            lambda: jpt.optimizer.Momentum(0.1, momentum=0.9)
    if name in ("lm", "lm_ragged"):
        spec = jmodels.get_model("transformer_lm", **cases.LM)
    elif name == "resnet_bn":
        spec = jmodels.get_model("resnet", **cases.RESNET)
    else:
        spec = jmodels.get_model("transformer", **cases.NMT)
    return spec.model, spec.optimizer


def _case(name):
    """(batch, params, state) as numpy: the batch from a numpy seed, the
    weights from the port's seeded init."""
    rng = np.random.RandomState(3)
    if name in ("mlp", "bn"):
        batch = (rng.randn(8, 3).astype(np.float32), rng.randn(8).astype(np.float32))
    elif name in ("lm", "lm_ragged"):
        batch = tuple(np.asarray(b) for b in jmodels.get_model(
            "transformer_lm", **cases.LM).synth_batch(4, rng))
        if name == "lm_ragged":
            batch += (np.array([16, 5, 11, 2], np.int32),)
    elif name == "resnet_bn":
        batch = tuple(np.asarray(b) for b in jmodels.get_model(
            "resnet", **cases.RESNET).synth_batch(4, rng))
    else:
        batch = tuple(np.asarray(b) for b in jmodels.get_model(
            "transformer", **cases.NMT).synth_batch(4, rng))
    model, _ = cases.port_model(name)
    v = model.init(0, *(torch.from_numpy(b) for b in batch), device="cpu")
    return (batch, {k: t.numpy() for k, t in v.params.items()},
            {k: t.numpy() for k, t in v.state.items()})


def _port_single(name, batch, params, state):
    model, opt_fn = cases.port_model(name)
    opt = opt_fn()
    v = Variables(cases.tensors(params), cases.tensors(state))
    o = opt.create_state(v.params)
    step = opt.minimize(model)
    losses = []
    for _ in range(cases.STEPS):
        out = step(v, o, *(torch.from_numpy(b) for b in batch))
        v, o = out.variables, out.opt_state
        losses.append(float(out.loss))
    return losses, cases.numpy_state(v, o)


def _jax_dp(name, batch, params, state):
    model, opt_fn = _jax_model(name)
    dp = JDataParallel(model, opt_fn(), mesh=jmake_mesh(data=2, devices=jax.devices()[:2]),
                       donate=False)
    v, o = dp.init(jax.random.PRNGKey(0), *batch, variables=JVariables(
        {k: jnp.asarray(a) for k, a in params.items()},
        {k: jnp.asarray(a) for k, a in state.items()}))
    losses = []
    for _ in range(cases.STEPS):
        out = dp.step(v, o, *batch)
        v, o = out.variables, out.opt_state
        losses.append(float(out.loss))
    return losses, ({k: np.asarray(a) for k, a in v.params.items()},
                    {k: np.asarray(a) for k, a in v.state.items()},
                    {s: {k: np.asarray(a) for k, a in d.items()} for s, d in o.slots.items()})


@pytest.fixture(scope="module")
def runs():
    inputs = {name: _case(name) for name in MODELS}
    ranks = launch.spawn(cases.dp_models, 2, args=(inputs,), device="cpu")
    return inputs, ranks


def _zero_grad_in_exact_arithmetic(name):
    """The attention k projections' biases (a constant added to all of a
    row's scores cancels in the softmax) and the bn net's fc bias that
    feeds a train-mode BN (BN subtracts the batch mean): their gradients
    are rounding noise."""
    return name.endswith("self_attn/k/b") or name == "h/b"


def _lr_sum(name):
    """What three updates can move a parameter by, at most, under Adam:
    the sum of the scheduled rates (the NMT's Noam schedule included)."""
    opt = cases.port_model(name)[1]()
    return sum(opt.scheduler(t) for t in range(cases.STEPS))


def _assert_state_close(got, want, name, lr):
    params, state, slots = got
    wparams, wstate, wslots = want
    assert set(params) == set(wparams) and set(state) == set(wstate)
    for k, a in wparams.items():
        atol = lr if _zero_grad_in_exact_arithmetic(k) else 1e-4
        np.testing.assert_allclose(params[k], a, rtol=0, atol=atol, err_msg=f"{name} {k}")
    for k, a in wstate.items():
        np.testing.assert_allclose(state[k], a, rtol=0, atol=1e-5, err_msg=f"{name} state {k}")
    for s, d in wslots.items():
        for k, a in d.items():
            if _zero_grad_in_exact_arithmetic(k):
                continue
            if name == "resnet_bn":  # a velocity is a sum of gradients
                rel = np.linalg.norm(slots[s][k] - a) / max(np.linalg.norm(a), 1e-12)
                assert rel <= 1e-4, (name, s, k, rel)
            else:
                np.testing.assert_allclose(slots[s][k], a, rtol=1e-4, atol=1e-7,
                                           err_msg=f"{name} {s}/{k}")


@pytest.mark.parametrize("name", MODELS)
def test_dp2_matches_jax_dp2_and_single_device(runs, name):
    inputs, ranks = runs
    batch, params, state = inputs[name]
    got = ranks[0][(name, False)]
    lr = _lr_sum(name)
    single_losses, single = _port_single(name, batch, params, state)
    jax_losses, jax_state = _jax_dp(name, batch, params, state)
    np.testing.assert_allclose(got["losses"], single_losses, rtol=1e-5)
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-5)
    _assert_state_close(got["state"], single, name, lr)
    _assert_state_close(got["state"], jax_state, name, lr)
    # no replica drift: the two ranks hold the same bits
    other = ranks[1][(name, False)]
    assert got["losses"] == other["losses"]
    for a, b in zip(got["state"], other["state"]):
        for k in a:
            if isinstance(a[k], dict):
                for kk in a[k]:
                    np.testing.assert_array_equal(a[k][kk], b[k][kk])
            else:
                np.testing.assert_array_equal(a[k], b[k])
    # the loss output is the global loss, batch outputs are gathered
    assert got["output_loss"] == pytest.approx(got["losses"][-1], rel=1e-6)
    rows = batch[0].shape[0]
    assert any(s and s[0] == rows for s in got["output_shapes"])


def test_resnet_bn_statistics_move(runs):
    """The BN moving statistics changed, on both ranks alike (the global
    batch's statistics, not a rank's own)."""
    inputs, ranks = runs
    _, _, state = inputs["resnet_bn"]
    got = ranks[0][("resnet_bn", False)]["state"][1]
    assert state and all(not np.array_equal(got[k], state[k]) for k in state)


def test_zero1_equals_plain_step_with_sharded_slots(runs):
    inputs, ranks = runs
    params = inputs["lm"][1]
    for rank in range(2):
        plain, zero = ranks[rank][("lm", False)], ranks[rank][("lm", True)]
        assert zero["losses"] == plain["losses"]
        for k in params:
            np.testing.assert_array_equal(zero["state"][0][k], plain["state"][0][k])
        for s, d in zero["state"][2].items():
            for k, rows in d.items():
                full = plain["state"][2][s][k]
                dim = next((i for i, n in enumerate(full.shape) if n % 2 == 0), None)
                if dim is None:  # no dim splits over 2: replicated
                    np.testing.assert_array_equal(rows, full)
                    continue
                assert rows.shape[dim] * 2 == full.shape[dim], (s, k)
                h = full.shape[dim] // 2
                np.testing.assert_array_equal(
                    rows, np.take(full, range(rank * h, (rank + 1) * h), axis=dim))
    # a rank's slot bytes are half the plain step's
    zero_bytes = sum(a.nbytes for d in ranks[0][("lm", True)]["state"][2].values()
                     for a in d.values())
    plain_bytes = sum(a.nbytes for d in ranks[0][("lm", False)]["state"][2].values()
                      for a in d.values())
    assert zero_bytes <= 0.51 * plain_bytes
    # the layout each rank saves: its own rows, owned
    for shape, window, owner in ranks[1][("lm", True)]["template"]:
        assert owner or all(b - a == s for (a, b), s in zip(window, shape))


def test_step_ragged_equals_single_device_and_replicas_stay_equal(runs):
    inputs, ranks = runs
    batch, params, state = inputs["mlp"]
    ragged = tuple(b[:5] for b in batch)
    model, opt_fn = cases.port_model("mlp")
    opt = opt_fn()
    v = Variables(cases.tensors(params), {})
    out = opt.minimize(model)(v, opt.create_state(v.params), *(torch.from_numpy(b) for b in ragged))
    assert ranks[0]["ragged"]["divisible"] is False
    np.testing.assert_allclose(ranks[0]["ragged"]["loss"], float(out.loss), rtol=1e-6)
    for k, a in out.variables.params.items():
        np.testing.assert_allclose(ranks[0]["ragged"]["state"][0][k], a.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ranks[0]["ragged"]["state"][0][k],
                                      ranks[1]["ragged"]["state"][0][k])


@pytest.mark.parametrize("name", ["mlp", "bn"])
def test_minimize_axis_name_matches_jax_pmean(name):
    """The pmap form: each rank steps on its half of the batch with its own
    batch statistics; gradients, loss and the changed BN state are
    averaged over the axis — against ``jax.pmap`` of the JAX package's
    ``minimize(axis_name="data")`` on 2 devices."""
    batch, params, state = _case(name)
    ranks = launch.spawn(cases.minimize_axis, 2, args=(name, batch, params, state), device="cpu")
    model, opt_fn = _jax_model(name)
    opt = opt_fn()
    step = jax.pmap(opt.minimize(model, axis_name="data"), axis_name="data",
                    devices=jax.devices()[:2])
    v = JVariables({k: jnp.asarray(a) for k, a in params.items()},
                   {k: jnp.asarray(a) for k, a in state.items()})
    o = opt.create_state(v.params)
    rep = lambda t: jax.tree_util.tree_map(lambda a: jnp.stack([a, a]), t)  # noqa: E731
    v, o = rep(v), rep(o)
    local = tuple(b.reshape((2, b.shape[0] // 2) + b.shape[1:]) for b in batch)
    losses = []
    for _ in range(cases.STEPS):
        out = step(v, o, *local)
        v, o = out.variables, out.opt_state
        losses.append(float(out.loss[0]))
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["losses"], losses, rtol=1e-5)
        jstate = ({k: np.asarray(a[r]) for k, a in v.params.items()},
                  {k: np.asarray(a[r]) for k, a in v.state.items()},
                  {s: {k: np.asarray(a[r]) for k, a in d.items()} for s, d in o.slots.items()})
        _assert_state_close(ranks[r]["state"], jstate, name, _lr_sum(name))
    if name == "bn":  # each rank's own statistics, then their mean: not the global batch's
        assert ranks[0]["state"][1] and all(
            np.array_equal(ranks[0]["state"][1][k], ranks[1]["state"][1][k])
            for k in ranks[0]["state"][1])


def test_batch_outputs_gathers_only_the_named_outputs(runs):
    """``batch_outputs``: by default (and when named) the MLP's per-row
    output is gathered to the global batch, equal to the single-device
    step's; ``()`` leaves each rank its own rows; naming the 0-d loss
    raises."""
    inputs, ranks = runs
    batch, params, _ = inputs["mlp"]
    model, opt_fn = cases.port_model("mlp")
    opt = opt_fn()
    v = Variables(cases.tensors(params), {})
    want = opt.minimize(model)(v, opt.create_state(v.params),
                               *(torch.from_numpy(b) for b in batch)).outputs[1].numpy()
    rows = len(batch[0])
    for r in range(2):
        got = ranks[r]["batch_outputs"]
        for named in (None, (1,)):
            assert got[named][0] == got[named][2] == (rows,) + want.shape[1:]
            np.testing.assert_allclose(got[named][1], want, rtol=1e-5, atol=1e-6)
        assert got[()][0] == got[()][2] == (rows // 2,) + want.shape[1:]
        np.testing.assert_allclose(got[()][1], want[r * rows // 2:(r + 1) * rows // 2],
                                   rtol=1e-5, atol=1e-6)
        assert "output 0" in got["loss_named"] and "batch_outputs=" in got["loss_named"]

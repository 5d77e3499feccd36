"""The port's small Python-layer modules against the JAX package on the
CPU: ``transpiler/memory.py`` (rematerialization policies), ``tensor``
(``RaggedBatch``, ``create_lod_tensor``), ``average``, ``evaluator`` and
``debugger``.

Tolerances: a rematerialized run's loss and gradients equal the plain
run's exactly (the same operators on the same inputs, recomputed), and
match the JAX package's plain and rematerialized runs at rtol 1e-5 /
atol 1e-6 (f32 products summed in other orders).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import average as javerage
from paddle_tpu import evaluator as jevaluator
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.transpiler import memory as jmemory
import paddle_tpu_torch as pt
from paddle_tpu_torch import average, convert, debugger, evaluator, executor, framework
from paddle_tpu_torch.core.config import flags
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.transpiler import memory

RTOL, ATOL = 1e-5, 1e-6


def _tmlp(x, y):
    h = pt.layers.fc(x, size=16, act="relu")
    return torch.mean(pt.ops.nn.square_error_cost(pt.layers.fc(h, size=1), y))


def _jmlp(x, y):
    h = jpt.layers.fc(x, size=16, act="relu")
    return jnp.mean(jpt.ops.nn.square_error_cost(jpt.layers.fc(h, size=1), y))


@pytest.fixture(scope="module")
def mlp_case():
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 1).astype(np.float32)
    jmodel = jpt.build(_jmlp)
    jvars = jmodel.init(0, x, y)

    def jloss(model):
        return lambda p: model.apply(JVariables(p, jvars.state), x, y)[0]

    jplain = jax.value_and_grad(jloss(jmodel))(jvars.params)
    jremat = jax.value_and_grad(jloss(jmemory.memory_optimize(jmodel, "full_remat")))(jvars.params)
    return x, y, convert.params_from_jax(jvars.params, "cpu"), jplain, jremat


def _loss_and_grads(model, params, x, y):
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = model.apply(framework.Variables(p, {}), torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads))


@pytest.mark.parametrize("policy", sorted(memory.POLICIES) + ["callable"])
def test_memory_optimize_keeps_values_and_grads(mlp_case, policy):
    x, y, params, jplain, jremat = mlp_case
    model = pt.build(_tmlp)
    if policy == "callable":  # a policy function passes through
        policy = memory.POLICIES["save_dots"]
    rmodel = memory.memory_optimize(model, policy=policy)
    assert rmodel.name == model.name + "_remat"
    loss, grads = _loss_and_grads(model, params, x, y)
    rloss, rgrads = _loss_and_grads(rmodel, params, x, y)
    assert torch.equal(rloss, loss)
    for k in grads:
        assert torch.equal(rgrads[k], grads[k]), k
    for jloss, jgrads in (jplain, jremat):
        np.testing.assert_allclose(float(rloss), float(jloss), rtol=RTOL)
        for k in grads:
            np.testing.assert_allclose(rgrads[k].numpy(), np.asarray(jgrads[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_memory_optimize_function_form_recomputes():
    calls = []

    def block(w, x):
        calls.append(1)
        h = torch.relu(x @ w)
        return (h * (torch.rand(h.shape) > 0.5)).sum()  # the default generator

    w = torch.randn(4, 4, requires_grad=True)
    x = torch.randn(3, 4)
    torch.manual_seed(3)
    plain_grad = torch.autograd.grad(block(w, x), w)[0]
    torch.manual_seed(3)
    calls.clear()
    (grad,) = torch.autograd.grad(memory.memory_optimize(block)(w, x), w)
    assert len(calls) == 2  # the forward, then its recompute in backward
    assert torch.equal(grad, plain_grad)  # with the same dropout mask
    assert memory.release_memory() is None
    with pytest.raises(KeyError):
        memory.memory_optimize(pt.build(_tmlp), policy="nonexistent")


def test_remat_model_replays_the_apply_generators_draws():
    def net(x):
        h = pt.layers.dropout(pt.layers.fc(x, size=16, act="relu"), 0.5)
        return torch.sum(pt.layers.fc(h, size=1))

    model = pt.build(net)
    x = torch.randn(8, 4)
    params = model.init(0, x, device="cpu").params
    grads = []
    for m in (model, memory.memory_optimize(model, "save_dots")):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = m.apply(framework.Variables(p, {}), x, is_train=True,
                          rng=torch.Generator().manual_seed(5))
        grads.append(torch.autograd.grad(loss, list(p.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_create_lod_tensor_matches_jax():
    cases = [
        (([np.arange(3), np.arange(5)],), {}),
        ((np.arange(8).reshape(8, 1),), {"recursive_seq_lens": [[3, 5]]}),
    ]
    for args, kw in cases:
        rb, jrb = pt.create_lod_tensor(*args, **kw), jpt.create_lod_tensor(*args, **kw)
        np.testing.assert_array_equal(rb.data, jrb.data)
        np.testing.assert_array_equal(rb.lengths, jrb.lengths)
        np.testing.assert_array_equal(rb.mask(), jrb.mask())
    rb = pt.create_lod_tensor([np.arange(3), np.arange(5)])
    assert rb.data.shape == (2, 5) and list(rb.lengths) == [3, 5] and rb.mask().sum() == 8
    rb3 = pt.create_random_int_lodtensor([[2, 4]], base_shape=[1], high=9, seed=0)
    jrb3 = jpt.create_random_int_lodtensor([[2, 4]], base_shape=[1], high=9, seed=0)
    np.testing.assert_array_equal(rb3.data, jrb3.data)
    assert rb3.data.shape == (2, 4, 1) and rb3.data.max() <= 9
    with pytest.raises(EnforceError):
        pt.create_lod_tensor(np.arange(7).reshape(7, 1), recursive_seq_lens=[[3, 5]])


def test_weighted_average_and_evaluator_names_match_jax():
    avg, javg = average.WeightedAverage(), javerage.WeightedAverage()
    for value, weight in ((np.array([1.0, 2.0]), 2.0), (4.0, 1.0), (np.ones((2, 2)), 0.5)):
        avg.add(value, weight)
        javg.add(value, weight)
    assert avg.eval() == javg.eval()
    avg.reset()
    with pytest.raises(ValueError):
        avg.eval()
    assert evaluator.__all__ == jevaluator.__all__
    acc = evaluator.Accuracy()
    acc.update(value=0.5, weight=4)
    acc.update(value=1.0, weight=4)
    assert acc.eval() == pytest.approx(0.75)


def _dmodel():
    def net(x):
        return pt.layers.fc(pt.layers.fc(x, size=8, act="relu"), size=2)

    return pt.build(net)


def test_program_to_text_and_hlo():
    model = _dmodel()
    x = torch.randn(4, 3)
    variables = model.init(0, x, device="cpu")
    txt = debugger.program_to_text(model, variables, x)
    assert "aten.matmul" in txt or "aten.mm" in txt or "aten.addmm" in txt
    code = debugger.program_to_hlo(model, variables, x)
    assert "def forward" in code and "torch.ops.aten" in code
    with pytest.raises(NotImplementedError, match="no XLA"):
        debugger.program_to_hlo(model, variables, x, optimized=True)


def test_draw_graph(tmp_path):
    model = _dmodel()
    x = torch.randn(2, 3)
    variables = model.init(0, x, device="cpu")
    path = str(tmp_path / "g.dot")
    dot = debugger.draw_graph(model, variables, x, path=path)
    assert dot.startswith("digraph") and "->" in dot and 'label="output"' in dot
    assert open(path).read() == dot


def test_memory_summary():
    assert debugger.memory_summary("cpu") == {}  # the JAX package's answer for the CPU
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        debugger.memory_summary()  # the card by default


def test_nan_guard():
    before = flags().check_nan_inf
    exe = executor.Executor("cpu")
    with debugger.nan_guard():
        assert flags().check_nan_inf
        with pytest.raises(EnforceError, match="NaN"):
            exe.run(lambda v: torch.log(v - 10.0), torch.zeros(2), fetch=True)
    assert flags().check_nan_inf == before  # flag restored

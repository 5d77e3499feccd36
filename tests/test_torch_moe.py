"""The port's mixture-of-experts and expert parallelism against the JAX
package's, on the CPU: ``switch_gate`` and ``top2_gate`` (dispatch,
combine, aux loss and the logits' gradient; with ``token_mask`` and an
overflowing expert), ``moe_ffn`` (outputs, aux and gradients), the MoE LM
(top1 and top2, ragged; the aux term in training only) — the counterparts
of ``tests/test_parallel_extensions.py:89-160,286-341`` and
``tests/test_lm_moe.py`` — then, on gloo ranks:

- the gates on a rank's block of the batch inside a data-parallel step,
  rows over two ``data`` ranks and row segments over two ``seq`` ranks,
  with an expert that overflows: the same tokens are kept and dropped as
  the JAX package's gate on the global batch keeps and drops;
- ``moe_ffn`` with its experts split over ``expert=2`` (each rank its
  block), against the JAX package's on the whole tokens, every gradient;
- ``DataParallel`` steps of the MoE LM on ``expert=2`` and ``data=2`` (two
  ranks) and on ``seq=2 x expert=2`` with the ring (four ranks):
  parameters after three steps against the JAX ``DataParallel`` on
  ``expert=2``;
- the process group and coordinates of every axis of the JAX tests' mesh
  shapes, at four ranks;
- ``Trainer(parallel=True)`` on ``expert=2`` with sharded checkpoints:
  auto-resume equals the uninterrupted run bit for bit, and the sharded
  checkpoints cross packages both ways;
- the refusals that stay (``pipe_mesh`` beside MoE, MoE in the decoders,
  ``model`` or ``pipe`` beside ``expert``, ZeRO-1 on an expert mesh).

Tolerances are the JAX tests' own: forward rtol 2e-4, atol 2e-5; MoE
gradients rtol 3e-4, atol 2e-5 (``tests/test_lm_moe.py:100-105``); LM
losses rtol 1e-4; parameters after three Adam steps atol 1e-4, the
attention k biases at the rates' sum (``test_torch_data_parallel.py``).
Dispatch masks are compared exactly.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jpt
import paddle_tpu_torch as pt
import torch_parallel_cases as cases
from paddle_tpu import checkpoint_sharded as jcks
from paddle_tpu import models as jmodels
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.parallel import DataParallel as JDataParallel
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.framework import ParamAttr, Variables
from paddle_tpu_torch.models import transformer_lm as tlm
from paddle_tpu_torch.parallel import DataParallel, P, launch, make_mesh, moe, sharding

FWD = dict(rtol=2e-4, atol=2e-5)
MOE_GRAD = dict(rtol=3e-4, atol=2e-5)
E = 4


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# -- the gates ----------------------------------------------------------------
def _gate_case(router, capacity, masked, seed):
    """(router, logits [4, 8, E], capacity, token_mask [4, 8] or None, wc,
    wa): capacity 3 of 32 tokens over 4 experts overflows."""
    rng = np.random.RandomState(seed)
    logits = 2 * _rand(rng, 4, 8, E)
    tm = None
    if masked:
        tm = (np.arange(8)[None, :] < np.array([8, 3, 6, 1])[:, None]).astype(np.float32)
    return (router, logits, capacity, tm, _rand(rng, 4, 8, E, capacity), 0.7)


GATE_CASES = {
    "top1": _gate_case("top1", 10, False, 1),
    "top1_overflow_masked": _gate_case("top1", 3, True, 2),
    "top2": _gate_case("top2", 20, False, 3),
    "top2_overflow_masked": _gate_case("top2", 5, True, 4),
}


def _jax_gate(case):
    """The JAX gate on the global batch: dispatch, combine, aux and the
    logits' gradient of sum(wc * combine) + wa * aux, as [B, T, ...]."""
    router, logits, capacity, tm, wc, wa = case
    fn = jmoe._ROUTERS[router][0]
    shape = logits.shape
    flat_tm = None if tm is None else jnp.asarray(tm.reshape(-1))

    def f(lg):
        d, c, aux = fn(lg.reshape(-1, shape[-1]), capacity, token_mask=flat_tm)
        return jnp.sum(jnp.asarray(wc).reshape(c.shape) * c) + wa * aux, (d, c, aux)

    (_, (d, c, aux)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(logits))
    return (np.asarray(d).reshape(shape[:2] + d.shape[1:]),
            np.asarray(c).reshape(shape[:2] + c.shape[1:]), float(aux), np.asarray(g))


@pytest.mark.parametrize("name", list(GATE_CASES))
def test_gate_matches_jax(name):
    """One process, the whole batch: the JAX package's routing."""
    router, logits, capacity, tm, wc, wa = GATE_CASES[name]
    d_want, c_want, aux_want, g_want = _jax_gate(GATE_CASES[name])
    x = torch.from_numpy(logits).requires_grad_(True)
    d, c, aux = moe._ROUTERS[router][0](
        x.reshape(-1, E), capacity, token_mask=None if tm is None else torch.from_numpy(
            tm.reshape(-1)))
    (g,) = torch.autograd.grad((torch.from_numpy(wc).reshape(c.shape) * c).sum() + wa * aux, [x])
    np.testing.assert_array_equal(d.numpy().reshape(d_want.shape), d_want)
    np.testing.assert_allclose(c.detach().numpy().reshape(c_want.shape), c_want, **FWD)
    np.testing.assert_allclose(float(aux.detach()), aux_want, **FWD)
    np.testing.assert_allclose(g.numpy(), g_want, **MOE_GRAD)
    if "overflow" in name:  # some routed token was dropped
        assert d_want.sum() < (tm.sum() if tm is not None else tm.size) * (
            1 if router == "top1" else 2)


# -- moe_ffn and the MoE LM, one process ----------------------------------------
def _ffn_case(router, masked, seed):
    """(kwargs, x [2, 8, 16], token_mask, params, w) with the port's init's
    weights."""
    rng = np.random.RandomState(seed)
    kw = dict(num_experts=E, d_ff=32, capacity_factor=0.75, router=router)
    x = _rand(rng, 2, 8, 16)
    tm = None
    if masked:
        tm = (np.arange(8)[None, :] < np.array([8, 5])[:, None]).astype(np.float32)
    model = pt.build(lambda x_: moe.moe_ffn(x_, name="moe", **kw), name="moe_net")
    params = {k: t.numpy() for k, t in model.init(0, torch.from_numpy(x), device="cpu")
              .params.items()}
    return kw, x, tm, params, _rand(rng, 2, 8, 16)


FFN_CASES = {"top1": _ffn_case("top1", False, 5), "top2_masked": _ffn_case("top2", True, 6)}


def _jax_ffn(case):
    kw, x, tm, params, w = case
    model = jpt.build(lambda x_, tm_=None: jmoe.moe_ffn(x_, name="moe", token_mask=tm_, **kw),
                      name="moe_net")
    args = (jnp.asarray(x),) + (() if tm is None else (jnp.asarray(tm),))

    def f(p, xx):
        (y, aux), _ = model.apply(JVariables(p, {}), xx, *args[1:])
        return jnp.sum(jnp.asarray(w) * y) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(
        {k: jnp.asarray(a) for k, a in params.items()}, args[0])
    return np.asarray(y), float(aux), np.asarray(gx), {k: np.asarray(g) for k, g in gp.items()}


@pytest.mark.parametrize("name", list(FFN_CASES))
def test_moe_ffn_matches_jax(name):
    kw, x, tm, params, w = FFN_CASES[name]
    y_want, aux_want, gx_want, gp_want = _jax_ffn(FFN_CASES[name])
    model = pt.build(lambda x_, tm_=None: moe.moe_ffn(x_, name="moe", token_mask=tm_, **kw),
                     name="moe_net")
    ps = {k: torch.from_numpy(a.copy()).requires_grad_(True) for k, a in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    args = () if tm is None else (torch.from_numpy(tm),)
    (y, aux), _ = model.apply(Variables(ps, {}), xt, *args)
    grads = torch.autograd.grad((torch.from_numpy(w) * y).sum() + aux, [xt] + list(ps.values()))
    np.testing.assert_allclose(y.detach().numpy(), y_want, **FWD)
    np.testing.assert_allclose(float(aux.detach()), aux_want, **FWD)
    np.testing.assert_allclose(grads[0].numpy(), gx_want, **MOE_GRAD)
    for k, g in zip(ps, grads[1:]):
        np.testing.assert_allclose(g.numpy(), gp_want[k], err_msg=k, **MOE_GRAD)
    if tm is not None:  # padding rows: zero output
        assert not y.detach().numpy()[1, 5:].any()


def _moe_lm(router, ragged):
    kw = dict(cases.MOE_LM, moe_router=router, moe_capacity_factor=0.75)
    spec = tmodels.get_model("transformer_lm", device="cpu", **kw)
    batch = tuple(b.numpy() for b in spec.synth_batch(4, np.random.RandomState(17)))
    if ragged:
        batch += (np.array([16, 9, 4, 13], np.int32),)
    params = {k: t.numpy() for k, t in spec.model.init(
        0, *(torch.from_numpy(b) for b in batch), device="cpu").params.items()}
    return kw, spec, batch, params


@pytest.mark.parametrize("router, ragged", [("top1", False), ("top2", True)])
def test_moe_lm_matches_jax(router, ragged):
    """The MoE LM's train loss (with the aux term), its eval loss (pure
    NLL) and every parameter's gradient, against the JAX package's."""
    kw, spec, batch, params = _moe_lm(router, ragged)
    jspec = jmodels.get_model("transformer_lm", **kw)

    def jloss(p, is_train):
        (l, _, _), _ = jspec.model.apply(JVariables(p, {}), *batch, is_train=is_train)
        return l

    jp = {k: jnp.asarray(a) for k, a in params.items()}
    want, gwant = jax.jit(jax.value_and_grad(lambda p: jloss(p, True)))(jp)
    want_eval = float(jax.jit(lambda p: jloss(p, False))(jp))
    ps = {k: torch.from_numpy(a.copy()).requires_grad_(True) for k, a in params.items()}
    tb = [torch.from_numpy(b) for b in batch]
    (loss, _, _), _ = spec.model.apply(Variables(ps, {}), *tb, is_train=True)
    grads = torch.autograd.grad(loss, list(ps.values()))
    (loss_eval, _, _), _ = spec.model.apply(Variables(ps, {}), *tb, is_train=False)
    loss, loss_eval = float(loss.detach()), float(loss_eval.detach())
    np.testing.assert_allclose(loss, float(want), rtol=1e-4)
    np.testing.assert_allclose(loss_eval, want_eval, rtol=1e-4)
    assert loss > loss_eval  # the aux term, in training only
    for k, g in zip(ps, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(gwant[k]), err_msg=k, **MOE_GRAD)
    assert any(np.abs(g.numpy()).sum() > 0 for k, g in zip(ps, grads) if k.endswith("w_gate"))


# -- the refusals ---------------------------------------------------------------
def test_moe_decoders_and_unported_meshes_refused():
    kw, spec, batch, params = _moe_lm("top1", False)
    tparams = {k: torch.from_numpy(a) for k, a in params.items()}
    prompt = torch.from_numpy(batch[0][:2, :4])
    cfg = spec.extra["cfg"]
    with pytest.raises(Exception, match="MoE"):
        tlm.generate(tparams, prompt, 3, cfg, device="cpu")
    with pytest.raises(Exception, match="MoE"):
        tlm.generate_beam(tparams, prompt, 3, cfg, beam_size=2, device="cpu")
    with pytest.raises(Exception, match="MoE"):
        tlm.PagedDecoder(tparams, cfg, page_size=4, table_width=4)
    # the JAX package's MoE checks, at init
    for bad, match in ((dict(ffn_activation="swiglu"), "ffn_activation"),
                       (dict(relu_dropout=0.1), "relu_dropout")):
        s = tmodels.get_model("transformer_lm", device="cpu", **cases.MOE_LM, **bad)
        with pytest.raises(Exception, match=match):
            s.model.init(0, *(torch.from_numpy(b) for b in batch), device="cpu")
    # pipeline parallelism beside MoE: the JAX package's refusal, when the
    # model runs (a one-stage pipe mesh)
    s = tmodels.get_model("transformer_lm", device="cpu", pipe_mesh=make_mesh(pipe=1),
                          **cases.MOE_LM)
    tb = [torch.from_numpy(b) for b in batch]
    with pytest.raises(Exception, match="pipe_mesh: MoE FFNs unsupported"):
        s.model.apply(s.model.init(0, *tb, device="cpu"), *tb)
    # model-axis parameter specs and model/pipe mesh axes are ported
    # (test_torch_tensor_parallel.py, test_torch_pipeline.py), and beside an
    # expert axis too (they step in test_torch_any_mesh.py: the MoE LM on
    # model=2 x expert=2); ZeRO-1 on an expert mesh is taken
    # (test_torch_composed_parallel.py)
    m = make_mesh(data=1, model=2, devices=[0, 1])
    fc = pt.build(lambda x: pt.layers.fc(x, 4, param_attr=ParamAttr(sharding=(None, "model"))),
                  name="tp")
    v = fc.init(0, torch.zeros(2, 4), device="cpu")
    assert sharding.param_shardings(m, fc.param_info, v.params)["fc/w"].spec == P(None, "model")
    for axes in (dict(data=1, model=2, expert=2), dict(data=1, pipe=2, expert=2)):
        dp = DataParallel(fc, pt.optimizer.SGD(0.1), device="cpu",
                          mesh=make_mesh(**axes, devices=[0, 1, 2, 3]))
        assert dp.num_devices == 4 and dp._token_axes == ("data",)
        # the column block over model where the mesh has that axis
        assert (dp._apply_fn() == dp._apply) == ("model" in axes)
    zero = DataParallel(fc, pt.optimizer.SGD(0.1), device="cpu", zero_shard_optimizer=True,
                        mesh=make_mesh(data=1, expert=2, devices=[0, 1]))
    assert zero.zero_shard_optimizer and zero.num_devices == 2


# -- on gloo ranks ----------------------------------------------------------------
def _dp_runs():
    """The MoE LM's DataParallel runs, from one batch and one set of weights
    (capacity 0.75 overflows)."""
    kw, spec, batch, params = _moe_lm("top1", False)
    runs2 = {
        "expert2": (dict(data=1, expert=2), kw, None, False, batch, params),
        "data2": (dict(data=2), kw, None, False, batch, params),
    }
    ring = dict(kw, seq_mode="ring")  # the composed ring (the flash ring: the seq tests)
    runs4 = {"seq2_expert2": (dict(data=1, seq=2, expert=2), ring,
                              [("data", "seq"), ("data", "seq")], False, batch, params)}
    return runs2, runs4


def _numpy(d):
    return {k: np.asarray(a) for k, a in d.items()}


def _jax_dp_expert2(kw, batch, params):
    """The JAX DataParallel on ``expert=2``: three Adam steps from
    ``params``; returns it, its state and its losses."""
    mesh = jmake_mesh(expert=2, data=1, devices=jax.devices()[:2])
    spec = jmodels.get_model("transformer_lm", **kw)
    dp = JDataParallel(spec.model, spec.optimizer(), mesh=mesh, donate=False)
    v, o = dp.init(jax.random.PRNGKey(0), *batch, variables=JVariables(
        {k: jnp.asarray(a) for k, a in params.items()}, {}))
    losses = []
    for _ in range(cases.STEPS):
        out = dp.step(v, o, *dp.put_batch(*batch))
        v, o = out.variables, out.opt_state
        losses.append(float(out.loss))
    return dp, v, o, losses


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe")
    runs2, runs4 = _dp_runs()
    kw, _, batch, params = _moe_lm("top1", False)
    trainer_batches = [batch] + [tuple(b.numpy() for b in tmodels.get_model(
        "transformer_lm", device="cpu", **kw).synth_batch(4, np.random.RandomState(s)))
        for s in (21, 22, 23)]
    # the JAX DataParallel on expert=2, its state after three steps saved
    # sharded: the reference of the DataParallel runs and the checkpoint
    # the port's ranks load
    jax_root = str(root / "jax")
    jdp, jv, jo, jlosses = _jax_dp_expert2(kw, batch, params)
    jcks.save_sharded(jax_root, (jv, jo), step=cases.STEPS)
    data_cases = {k: v for k, v in GATE_CASES.items()}
    seq_cases = {k: v for k, v in GATE_CASES.items() if "masked" in k}
    two = {
        "gates_data2": ("moe_gate_blocks", (dict(data=2), False, data_cases)),
        "gates_seq2": ("moe_gate_blocks", (dict(data=1, seq=2), True, seq_cases)),
        "ffn": ("moe_ffn_expert", (dict(data=1, expert=2), FFN_CASES)),
        "dp": ("sp_dp_steps", (runs2,)),
        "trainer": ("moe_trainer", ((str(root / "a"), str(root / "b")), trainer_batches,
                                    params, jax_root)),
    }
    four = {"dp": ("sp_dp_steps", (runs4,)), "axes": ("sp_axes", (FOUR_RANK_MESHES,))}
    got2 = launch.spawn(cases.calls, 2, args=(two,), device="cpu")
    got4 = launch.spawn(cases.calls, 4, args=(four,), device="cpu")
    return dict(two=got2, four=got4, runs2=runs2, runs4=runs4, root=root,
                jax_state=(jdp, jv, jo), jax_expert2=(jlosses, _numpy(jv.params)))


# the JAX tests' mesh shapes (seq=4 x data=2, seq=2 x data=4, expert=4 x
# data=2, seq=2 x expert=2 x data=2, seq=8; data=4 x model=2, pipe=2 x
# data=4) at four ranks, and the composed meshes of
# test_torch_composed_parallel.py
FOUR_RANK_MESHES = [dict(seq=2, data=2), dict(seq=2, data=2, expert=1), dict(expert=2, data=2),
                    dict(seq=2, expert=2, data=1), dict(seq=4), dict(data=2, model=2),
                    dict(pipe=2, data=2), dict(model=4), dict(pipe=2, model=2, data=1),
                    dict(data=1, seq=2, model=2)]


def test_mesh_axes_groups_match_jax(moe_ranks):
    """Each axis of the JAX tests' mesh shapes (at four ranks) has a process
    group: the collectives' ``axis_index``/``axis_size`` are the rank's
    coordinates in the JAX package's mesh of the same shape, and a sum over
    the last axis counts its members."""
    for r, rank in enumerate(moe_ranks["four"]):
        for axes, (got, coords, total) in zip(FOUR_RANK_MESHES, rank["axes"]):
            jm = jmake_mesh(**axes, devices=jax.devices()[:4])
            want = [int(c) for c in np.argwhere(np.vectorize(lambda d: d.id)(jm.devices) == r)[0]]
            assert coords == want, axes
            for i, a in enumerate(jm.axis_names):
                assert got[a] == (want[i], jm.shape[a], want[i]), (axes, a)
            assert total == jm.shape[jm.axis_names[-1]]


@pytest.mark.parametrize("split", ["gates_data2", "gates_seq2"])
def test_gates_on_blocks_route_as_the_global_batch(moe_ranks, split):
    """Each rank's block, routed inside the step context, keeps and drops
    exactly the JAX package's tokens of the global batch (an expert
    overflows), with its combine weights, the global aux loss and the
    logits' gradient."""
    for rank in moe_ranks["two"]:
        for name, got in rank[split].items():
            d, c, aux, g = _jax_gate(GATE_CASES[name])
            rows, seg = slice(*got["rows"]), slice(*got["seg"])
            n = (rows.stop - rows.start) * (seg.stop - seg.start)
            np.testing.assert_array_equal(got["dispatch"], d[rows, seg].reshape(n, *d.shape[2:]),
                                          err_msg=f"{split} {name}")
            np.testing.assert_allclose(got["combine"], c[rows, seg].reshape(n, *c.shape[2:]),
                                       err_msg=f"{split} {name}", **FWD)
            np.testing.assert_allclose(got["aux"], aux, err_msg=f"{split} {name}", **FWD)
            np.testing.assert_allclose(got["grad"], g[rows, seg], err_msg=f"{split} {name}",
                                       **MOE_GRAD)


@pytest.mark.parametrize("name", list(FFN_CASES))
def test_moe_ffn_expert_parallel_matches_jax(moe_ranks, name):
    """``expert=2``: each rank holds 2 of the 4 experts; outputs, aux and
    every gradient (the router's and the input's whole on both ranks, the
    experts' each rank's block) equal the JAX package's."""
    y_want, aux_want, gx_want, gp_want = _jax_ffn(FFN_CASES[name])
    for r, rank in enumerate(moe_ranks["two"]):
        got = rank["ffn"][name]
        np.testing.assert_allclose(got["out"], y_want, **FWD)
        np.testing.assert_allclose(got["aux"], aux_want, **FWD)
        np.testing.assert_allclose(got["dx"], gx_want, **MOE_GRAD)
        for k, g in got["grads"].items():
            want = gp_want[k]
            if k.endswith("w_gate"):
                assert got["shapes"][k] == want.shape
            else:  # this rank's experts
                assert got["shapes"][k][0] == E // 2
                want = want[r * E // 2:(r + 1) * E // 2]
            np.testing.assert_allclose(g, want, err_msg=k, **MOE_GRAD)


@pytest.mark.parametrize("name", ["expert2", "data2", "seq2_expert2"])
def test_dp_moe_lm_matches_jax_dp(moe_ranks, name):
    """Three Adam steps of the MoE LM (capacity 0.75: experts overflow) on
    ``expert=2``, ``data=2`` (two ranks) and ``seq=2 x expert=2`` with the
    composed ring (four ranks), each against the JAX DataParallel on
    ``expert=2`` (the same global step: the ring is exact attention); every
    replica of a parameter block bit-equal."""
    runs = moe_ranks["runs2"] if name in moe_ranks["runs2"] else moe_ranks["runs4"]
    ranks = moe_ranks["two"] if name in moe_ranks["runs2"] else moe_ranks["four"]
    axes = runs[name][0]
    losses, want = moe_ranks["jax_expert2"]
    opt = tmodels.get_model("transformer_lm", device="cpu", **cases.MOE_LM).optimizer()
    lr = sum(opt.scheduler(t) for t in range(cases.STEPS))
    for rank in ranks:
        got = rank["dp"][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, a in want.items():
            atol = lr if k.endswith("self_attn/k/b") else 1e-4
            np.testing.assert_allclose(got["state"][0][k], a, rtol=0, atol=atol, err_msg=k)
        if "expert" in axes:  # each rank holds its block of the experts
            assert got["local_shapes"]["layer_0/moe_ffn/w_in"][0] == E // axes["expert"]
    # ranks r and r' hold the same block when r = r' mod the expert axis
    # (the last, fastest axis): their parameters are bit-equal
    n_exp = axes.get("expert", 1)
    for r, rank in enumerate(ranks):
        assert rank["dp"][name]["digest"] == ranks[r % n_exp]["dp"][name]["digest"]


def test_trainer_expert2_resumes_and_checkpoints_cross_packages(moe_ranks):
    """``Trainer(parallel=True)`` on ``expert=2``: the run resumed from its
    sharded checkpoint equals the uninterrupted one bit for bit; that
    checkpoint loads in the JAX package (into its ``expert=2`` layout and
    into a whole tree), and the JAX package's ``expert=2`` checkpoint loads
    at the port's layout."""
    ranks = moe_ranks["two"]
    for rank in ranks:
        t = rank["trainer"]
        assert t["step"] == 8 and t["resumed_equal"]
        assert t["resumed_losses"] == t["whole_losses"][4:]
        assert t["local_shapes"]["layer_0/moe_ffn/w_in"][0] == E // 2
    full = ranks[0]["trainer"]["state"]
    # the port's checkpoint of the whole run, in the JAX package
    root = str(moe_ranks["root"] / "a")
    jdp, jv, jo = moe_ranks["jax_state"]
    for target in ((jv, jo), jdp.state_template(jv, jo)):
        (lv, lo), manifest = jcks.load_sharded(root, target)
        assert manifest["step"] == 8 and manifest["num_processes"] == 2
        for k, a in full[0].items():
            np.testing.assert_array_equal(np.asarray(lv.params[k]), a, err_msg=k)
        for s, d in lo.slots.items():
            for k, a in d.items():
                np.testing.assert_array_equal(np.asarray(a), full[2][s][k], err_msg=k)
    # the JAX package's checkpoint at the port's expert=2 layout
    for rank in ranks:
        state, step, mstep = rank["trainer"]["jax_loaded"]
        assert step == mstep == cases.STEPS
        for k, a in jv.params.items():
            np.testing.assert_array_equal(state[0][k], np.asarray(a), err_msg=k)
        for s, d in jo.slots.items():
            for k, a in d.items():
                np.testing.assert_array_equal(state[2][s][k], np.asarray(a), err_msg=k)

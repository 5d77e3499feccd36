"""The port's DataParallel on any mesh and spec the JAX package's GSPMD runs,
on gloo ranks (CPU), against the JAX package's ``DataParallel`` on the
same mesh (its 8-device CPU mesh), specs, seed and weights, and against the
port's one-device step on the global batch:

- (a) the MoE LM (``top1`` and ``top2``, capacity 0.75: tokens drop) on
  ``data=1 x model=2 x expert=2`` with batch specs ``P("data")`` (the
  tokens replicated over ``expert``) and ``P(("data", "expert"))`` (split
  over it: the experts' buffers are exchanged). Attention runs Megatron's
  split over ``model``; the experts split over ``expert`` only, replicated
  over ``model``, as in the JAX package. Each layer's kept tokens and aux
  loss equal the JAX package's (its one-device forward), a rank holds 2 of
  the 4 experts and half of q's columns;
- (b) a stored block: the MLP and the LM with every matrix annotated
  ``("data", None)`` (both packages' annotations replaced alike) on
  ``data=2``, with and without ZeRO-1: each rank holds half the rows, and
  of a split parameter half the slot bytes; a sharded checkpoint saved by
  either package loads in the other at world 1 and 2;
- (c) axes no spec uses: ``data=2 x tp=2``, ``pipe=2 x seq=2``, and the
  meshes once refused (``tp=2``, ``model=2 x expert=2``, ``pipe=2 x
  expert=2``, ``pipe=2 x model=2 x seq=2``) for the MLP: the replicas stay
  bit-equal;
- (d) ``P(("data", "seq"))`` on dim 0: ``leading_multiple``, ``pad_batch``
  and each rank's rows are the JAX package's, and so is the step;
- (e) ``Trainer(parallel=True)`` on (a)'s mesh with ``P(("data",
  "expert"))`` and sharded async checkpoints: the resumed run equals the
  uninterrupted one bit for bit.

Tolerances are ``test_torch_composed_parallel.py``'s: losses rtol 1e-5,
parameters after three Adam steps atol 1e-4 (the attention k biases, whose
gradient is zero in exact arithmetic, at the scheduled rates' sum), slots
(gradient moments) rtol 2e-4, atol 2e-4. The rank bodies live in
``torch_parallel_cases.py``; three spawns (4, 2 and 8 ranks) run them all.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jpt
import torch_parallel_cases as cases
from paddle_tpu import checkpoint_sharded as jcks
from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.optimizer import OptState as JOptState
from paddle_tpu.parallel import DataParallel as JDataParallel
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu_torch import checkpoint_sharded as tcks
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import Variables
from paddle_tpu_torch.parallel import launch

LOSS = dict(rtol=1e-5)
PARAM_ATOL = 1e-4
SLOT = dict(rtol=2e-4, atol=2e-4)
MOE_MESH = dict(data=1, model=2, expert=2)
ROUTERS = ("top1", "top2")
# batch spec names -> the dim-0 entry of every batch arg
ROWS = {"data": "data", "data_expert": ("data", "expert")}
D2 = dict(data=2)
# (c): the MLP on meshes whose axes beside data no spec splits, and ranks
REPLICAS = {"data2_tp2": (dict(data=2, tp=2), 4), "pipe2_seq2": (dict(data=1, pipe=2, seq=2), 4),
            "tp2": (dict(data=1, tp=2), 2), "model2_expert2": (MOE_MESH, 4),
            "pipe2_expert2": (dict(data=1, pipe=2, expert=2), 4),
            "pipe2_model2_seq2": (dict(data=1, pipe=2, model=2, seq=2), 8)}
DATA_SEQ = dict(data=2, seq=2)
PAD_ROWS = 6


@pytest.fixture(scope="module", autouse=True)
def jax_plain():
    saved = (jconfig.flags().use_flash_attention, jconfig.flags().use_bf16_compute)
    jconfig.set_flags(use_flash_attention=False, use_bf16_compute=False)
    yield
    jconfig.set_flags(use_flash_attention=saved[0], use_bf16_compute=saved[1])


def _moe_kw(router):
    return dict(cases.MOE_LM, moe_router=router, moe_capacity_factor=0.75)


def _lm_kw(name):
    """The port's LM kwargs of a run (the flash route: its plain version on
    the CPU); the JAX side takes them without ``flash``."""
    if name.startswith("moe"):
        return dict(_moe_kw(name.split("_")[1]), flash=True)
    return dict(cases.LM, flash=True)


@functools.lru_cache(maxsize=None)
def _inputs():
    """The MLP's 8-row batch and init, the LM's 8-row batch and init, the
    MoE LM's two 4-row batches and init (numpy seeds; the port's inits)."""
    rng = np.random.RandomState(0)
    mlp_batch = (rng.randn(8, 4).astype(np.float32), rng.randn(8).astype(np.float32))
    model, _ = cases.port_model("mlp")
    mlp_params = {k: t.numpy() for k, t in model.init(
        0, *(torch.from_numpy(b) for b in mlp_batch), device="cpu").params.items()}
    out = {"mlp": (mlp_batch, mlp_params)}
    for key, kw, rows, seed in (("lm", cases.LM, 8, 3), ("moe", cases.MOE_LM, 4, 17)):
        spec = tmodels.get_model("transformer_lm", device="cpu", **kw)
        batches = [tuple(b.numpy() for b in spec.synth_batch(rows, np.random.RandomState(s)))
                   for s in (seed, seed + 1)]
        params = {k: t.numpy() for k, t in spec.model.init(
            0, *(torch.from_numpy(b) for b in batches[0]), device="cpu").params.items()}
        out[key] = (batches, params)
    return out


def _moe_runs():
    """(a): name -> run (``am_steps``'s dict)."""
    batches, params = _inputs()["moe"]
    return {f"moe_{r}_{s}": dict(axes=MOE_MESH, model="lm", kw=_lm_kw(f"moe_{r}"),
                                 specs=[(ROWS[s],)] * len(batches[0]), batch=batches[0],
                                 params=params)
            for r in ROUTERS for s in ROWS}


def _stored_runs(root):
    """(b): the MLP and the LM with every matrix stored over data, ZeRO-1
    off and on, each saving its state and loading the JAX package's."""
    mlp_batch, mlp_params = _inputs()["mlp"]
    lm_batches, lm_params = _inputs()["lm"]
    runs = {}
    for model, batch, params in (("mlp", mlp_batch, mlp_params), ("lm", lm_batches[0], lm_params)):
        for zero in (False, True):
            name = f"{model}_stored" + ("_zero1" if zero else "")
            runs[name] = dict(axes=D2, model=model, kw=_lm_kw("lm"), zero=zero, stored=True,
                              batch=batch, params=params, save=str(root / f"port_{name}"),
                              load=str(root / f"jax_{name}"))
    return runs


def _mlp_run(axes, **kw):
    batch, params = _inputs()["mlp"]
    return dict(axes=axes, model="mlp", batch=batch, params=params, **kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("any_mesh")
    stored = _stored_runs(root)
    for name, run in stored.items():
        _jax_checkpoint(name, run)
    moe_batches, _ = _inputs()["moe"]
    four = {
        "steps": ("am_steps", ({
            **_moe_runs(),
            **{n: _mlp_run(a) for n, (a, r) in REPLICAS.items() if r == 4},
            "data_seq_rows": _mlp_run(DATA_SEQ, specs=[(("data", "seq"),)] * 2, pad=PAD_ROWS),
        },)),
        "trainer": ("am_trainer", ((str(root / "whole"), str(root / "resumed")), MOE_MESH,
                                   _lm_kw("moe_top1"), [(ROWS["data_expert"],)] * 2,
                                   list(moe_batches))),
    }
    two = {"steps": ("am_steps", ({**stored, "tp2": _mlp_run(REPLICAS["tp2"][0])},))}
    eight = {"steps": ("am_steps", ({"pipe2_model2_seq2": _mlp_run(
        REPLICAS["pipe2_model2_seq2"][0])},))}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(lambda: [launch.spawn(cases.calls, n, args=(todo,), device="cpu")
                                   for n, todo in ((4, four), (2, two), (8, eight))])
        _jax_references(stored)  # meanwhile: the JAX side's compiles
        got4, got2, got8 = job.result()
    return dict(four=got4, two=got2, eight=got8, root=root, stored=stored)


# -- the references -----------------------------------------------------------------
def _jax_model(run):
    """(model, optimizer) of the JAX package for a run, its param_info
    recorded and, for a stored run, its matrices annotated over data."""
    if run["model"] == "mlp":
        model = jpt.build(cases.mlp_net(jpt.layers, jpt.ops, jnp.mean), name="mlp")
        opt = jpt.optimizer.Adam(cases.MLP_LR)
    else:
        spec = jmodels.get_model("transformer_lm", **{k: v for k, v in run["kw"].items()
                                                      if k != "flash"})
        model, opt = spec.model, spec.optimizer()
    model.init(jax.random.PRNGKey(0), *run["batch"])
    if run.get("stored"):
        cases.store_rows(model)
    return model, opt


_JAX_DPS = {}


def _jax_dp(name, run):
    """The JAX package's DataParallel of a run on its own mesh (the first
    devices of the 8-device CPU mesh) and specs, and its state from the
    run's weights (built once a name)."""
    if name not in _JAX_DPS:
        _JAX_DPS[name] = _build_jax_dp(run)
    return _JAX_DPS[name]


def _build_jax_dp(run):
    model, opt = _jax_model(run)
    n = int(np.prod(list(run["axes"].values())))
    mesh = jmake_mesh(**run["axes"], devices=jax.devices()[:n])
    specs = run.get("specs")
    dp = JDataParallel(model, opt, mesh=mesh, donate=False,
                       zero_shard_optimizer=run.get("zero", False),
                       batch_specs=None if specs is None else [JP(*s) for s in specs])
    v, o = dp.init(jax.random.PRNGKey(0), *run["batch"], variables=JVariables(
        {k: jnp.asarray(a) for k, a in run["params"].items()}, {}))
    return dp, v, o


_JAX_STEPS = {}


def _jax_steps(name, run):
    """Three steps of the JAX package's DataParallel of a run: the losses,
    the parameters and the slots (cached by name)."""
    if name not in _JAX_STEPS:
        dp, v, o = _jax_dp(name, run)
        losses = []
        for _ in range(cases.STEPS):
            out = dp.step(v, o, *run["batch"])
            v, o = out.variables, out.opt_state
            losses.append(float(out.loss))
        _JAX_STEPS[name] = (losses, {k: np.asarray(a) for k, a in v.params.items()},
                            {s: {k: np.asarray(a) for k, a in d.items()}
                             for s, d in o.slots.items()})
    return _JAX_STEPS[name]


def _jax_checkpoint(name, run):
    """The JAX package's state of a stored run on data=2 (its weights,
    seeded slots, step 3), saved sharded in ``run["load"]``."""
    dp, v, o = _jax_dp(name, run)
    rng = np.random.RandomState(9)
    slots = {s: {k: jax.device_put(rng.randn(*a.shape).astype(np.float32), a.sharding)
                 for k, a in d.items()} for s, d in o.slots.items()}
    o = o._replace(step=jnp.int32(cases.STEPS), slots=slots)
    jcks.save_sharded(run["load"], (v, o), step=cases.STEPS)
    _JAX_CHECKPOINTS[name] = (dp, v, o)


_JAX_CHECKPOINTS = {}


def _jax_routers(router):
    """Each MoE layer's kept tokens and aux loss in the JAX package's
    one-device forward of the first batch (its routers wrapped)."""
    batches, params = _inputs()["moe"]
    spec = jmodels.get_model("transformer_lm", **_moe_kw(router))
    calls, saved = [], dict(jmoe._ROUTERS)

    def wrap(fn):
        def gate(logits, capacity, token_mask=None):
            dispatch, combine, aux = fn(logits, capacity, token_mask=token_mask)
            calls.append((int(jnp.sum(dispatch)), float(aux)))
            return dispatch, combine, aux

        return gate

    try:
        for key, (fn, routes) in saved.items():
            jmoe._ROUTERS[key] = (wrap(fn), routes)
        spec.model.apply(JVariables({k: jnp.asarray(a) for k, a in params.items()}, {}),
                         *batches[0], is_train=True)
    finally:
        jmoe._ROUTERS.update(saved)
    return calls


@functools.lru_cache(maxsize=None)
def _one_device(kind):
    """The port's one-device steps (minimize on the global batch) of
    ``kind`` ("mlp", "lm" or "moe_<router>"): losses and parameters."""
    if kind == "mlp":
        model, opt = cases.port_model("mlp")
        batch, params = _inputs()["mlp"]
    else:
        kw = _lm_kw(kind)
        kw.pop("flash")
        spec = tmodels.get_model("transformer_lm", device="cpu", **kw)
        model, opt = spec.model, spec.optimizer
        batches, params = _inputs()["moe" if kind.startswith("moe") else "lm"]
        batch = batches[0]
    opt = opt()
    v = Variables(cases.tensors(params), {})
    o = opt.create_state(v.params)
    step = opt.minimize(model)
    losses = []
    for _ in range(cases.STEPS):
        out = step(v, o, *(torch.from_numpy(b) for b in batch))
        v, o = out.variables, out.opt_state
        losses.append(float(out.loss))
    return losses, {k: t.numpy() for k, t in v.params.items()}


def _jax_references(stored):
    for name, run in _moe_runs().items():
        _jax_steps(name, run)
    for name, (axes, _) in REPLICAS.items():
        _jax_steps(name, _mlp_run(axes))
    _jax_steps("data_seq_rows", _mlp_run(DATA_SEQ, specs=[(("data", "seq"),)] * 2))
    for name, run in stored.items():
        _jax_steps(name, run)


def _lr_sum(kind):
    opt = topt.Adam(cases.MLP_LR) if kind == "mlp" else tmodels.get_model(
        "transformer_lm", device="cpu", **cases.LM).optimizer()
    return sum(opt.scheduler(t) for t in range(cases.STEPS))


def _held(got, name, kind):
    """A run's losses and parameters against the JAX package's
    DataParallel on the same mesh and specs and the port's one-device
    step; its slots against the JAX package's."""
    losses, params, slots = _JAX_STEPS[name]
    ref_losses, ref_params = _one_device(kind)
    np.testing.assert_allclose(got["losses"], losses, err_msg=name, **LOSS)
    np.testing.assert_allclose(got["losses"], ref_losses, err_msg=name, **LOSS)
    lr = _lr_sum("mlp" if kind == "mlp" else "lm")
    for k, a in params.items():
        atol = max(lr, PARAM_ATOL) if k.endswith("self_attn/k/b") else PARAM_ATOL
        np.testing.assert_allclose(got["state"][0][k], a, rtol=0, atol=atol, err_msg=f"{name} {k}")
        np.testing.assert_allclose(got["state"][0][k], ref_params[k], rtol=0, atol=atol,
                                   err_msg=f"{name} {k}")
    for s, d in slots.items():
        for k, a in d.items():
            if not k.endswith("self_attn/k/b"):
                np.testing.assert_allclose(got["state"][2][s][k], a, err_msg=f"{name} {s} {k}",
                                           **SLOT)


def _coords(axes, rank):
    """This rank's coordinate on each axis (the last varies fastest)."""
    names = list(axes)
    n = int(np.prod(list(axes.values())))
    pos = np.argwhere(np.arange(n).reshape([axes[a] for a in names]) == rank)[0]
    return dict(zip(names, (int(p) for p in pos)))


# -- (a) the MoE LM on model x expert ------------------------------------------------
@pytest.mark.parametrize("name", [f"moe_{r}_{s}" for r in ROUTERS for s in ROWS])
def test_moe_lm_on_model_expert_matches_jax(ranks, name):
    """Three steps of the MoE LM on ``data=1 x model=2 x expert=2`` equal
    the JAX package's DataParallel on that mesh and specs and the one-device
    step; a rank holds 2 of the 4 experts and half of q's columns; the
    tokens are split over ``expert`` only under ``P(("data", "expert"))``;
    the ranks of a block (the same ``model`` and ``expert`` coordinates)
    hold bit-equal parameters."""
    _, params = _inputs()["moe"]
    digests = {}
    for r, rank in enumerate(ranks["four"]):
        got = rank["steps"][name]
        _held(got, name, "_".join(name.split("_")[:2]))
        shapes = got["local_shapes"]
        assert shapes["layer_0/moe_ffn/w_in"][0] * 2 == cases.MOE_LM["moe_experts"]
        assert shapes["layer_0/self_attn/q/w"][1] * 2 == params["layer_0/self_attn/q/w"].shape[1]
        assert shapes["layer_0/moe_ffn/w_gate"] == params["layer_0/moe_ffn/w_gate"].shape
        assert got["token_axes"] == (("data", "expert") if name.endswith("expert") else ("data",))
        c = _coords(MOE_MESH, r)
        digests.setdefault((c["model"], c["expert"]), set()).add(got["digest"])
    assert len(digests) == 4 and all(len(d) == 1 for d in digests.values())


@pytest.mark.parametrize("name", [f"moe_{r}_{s}" for r in ROUTERS for s in ROWS])
def test_moe_kept_tokens_and_aux_per_layer_match_jax(ranks, name):
    """Each MoE layer's router in the first step keeps, over the global
    batch, the tokens the JAX package's one-device forward keeps (capacity
    0.75: some drop), with its aux loss, on every rank."""
    want = _jax_routers(name.split("_")[1])
    n_tokens = 4 * cases.MOE_LM["seq_len"] * (2 if name.split("_")[1] == "top2" else 1)
    assert len(want) == cases.MOE_LM["n_layers"] and all(k < n_tokens for k, _ in want)
    for rank in ranks["four"]:
        got = rank["steps"][name]["routers"]
        assert [k for k, _ in got] == [k for k, _ in want], name
        np.testing.assert_allclose([a for _, a in got], [a for _, a in want], rtol=1e-5)


# -- (b) stored blocks ------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mlp_stored", "mlp_stored_zero1", "lm_stored", "lm_stored_zero1"])
def test_stored_blocks_match_jax_and_hold_half(ranks, name):
    """Every matrix stored over ``data`` (FSDP-like) on ``data=2``: three
    steps equal the JAX package's DataParallel with the same annotations
    and the one-device step; each rank holds half of each matrix's rows;
    its parameter bytes and slot bytes are those of its windows (a split
    parameter's slots keep its split; under ZeRO-1 the replicated ones'
    split over data where it divides)."""
    kind = name.split("_")[0]
    params = _inputs()[kind][1]
    zero = name.endswith("zero1")
    n_slots = 2  # Adam's moments
    want_params = want_slots = 0
    for k, a in params.items():
        split = a.ndim >= 2 or (zero and a.shape[0] % 2 == 0)
        want_params += a.nbytes // (2 if a.ndim >= 2 else 1)
        want_slots += n_slots * a.size * 4 // (2 if split else 1)
    for rank in ranks["two"]:
        got = rank["steps"][name]
        _held(got, name, kind)
        for k, a in params.items():
            want = (a.shape[0] // 2,) + a.shape[1:] if a.ndim >= 2 else a.shape
            assert got["local_shapes"][k] == want, k
        assert got["param_bytes"] == want_params and got["slot_bytes"] == want_slots
    digests = {rank["steps"][name]["digest"] for rank in ranks["two"]}
    assert len(digests) == 2  # the windows differ


@pytest.mark.parametrize("name", ["mlp_stored", "mlp_stored_zero1", "lm_stored", "lm_stored_zero1"])
def test_stored_checkpoints_cross_packages(ranks, name):
    """The port's sharded checkpoint of a stored run (two ranks' windows)
    loads in the JAX package at world 2 (its data-sharded layout) and at
    world 1 (whole arrays), and in one port process; the JAX package's
    checkpoint of that layout loads at each port rank's windows and in one
    port process, equal leaf for leaf."""
    full = ranks["two"][0]["steps"][name]["state"]
    root = ranks["stored"][name]["save"]
    dp, jv, jo = _JAX_CHECKPOINTS[name]
    whole = (JVariables({k: jnp.zeros(a.shape) for k, a in full[0].items()}, {}),
             JOptState(step=jnp.int32(0), slots={s: {k: jnp.zeros(a.shape) for k, a in d.items()}
                                                 for s, d in full[2].items()}))
    for target in (dp.state_template(jv, jo), whole):
        (lv, lo), manifest = jcks.load_sharded(root, target)
        assert manifest["step"] == cases.STEPS and manifest["num_processes"] == 2
        for k, a in full[0].items():
            np.testing.assert_array_equal(np.asarray(lv.params[k]), a, err_msg=k)
        for s, d in full[2].items():
            for k, a in d.items():
                np.testing.assert_array_equal(np.asarray(lo.slots[s][k]), a, err_msg=k)
    like = (Variables({k: torch.zeros(a.shape) for k, a in full[0].items()}, {}),
            topt.OptState(step=0, slots={s: {k: torch.zeros(a.shape) for k, a in d.items()}
                                         for s, d in full[2].items()}))
    jax_root = ranks["stored"][name]["load"]
    (pv, po), _ = tcks.load_sharded(root, like)
    (qv, qo), _ = tcks.load_sharded(jax_root, like)
    for k, a in full[0].items():
        np.testing.assert_array_equal(pv.params[k].numpy(), a, err_msg=k)
        np.testing.assert_array_equal(qv.params[k].numpy(), np.asarray(jv.params[k]), err_msg=k)
    for s, d in jo.slots.items():
        for k, a in d.items():
            np.testing.assert_array_equal(qo.slots[s][k].numpy(), np.asarray(a), err_msg=k)
    assert int(qo.step) == cases.STEPS
    for rank in ranks["two"]:
        state, step, mstep = rank["steps"][name]["loaded"]
        assert step == mstep == cases.STEPS
        for k, a in jv.params.items():
            np.testing.assert_array_equal(state[0][k], np.asarray(a), err_msg=k)
        for s, d in jo.slots.items():
            for k, a in d.items():
                np.testing.assert_array_equal(state[2][s][k], np.asarray(a), err_msg=k)


# -- (c) axes no spec uses -----------------------------------------------------------------
@pytest.mark.parametrize("name", list(REPLICAS))
def test_unused_axes_hold_bit_equal_replicas(ranks, name):
    """The MLP on a mesh whose axes beside ``data`` no spec splits (the
    meshes once refused among them): the tokens split over ``data`` only,
    three steps equal the JAX package's DataParallel on that mesh and the
    one-device step, and every rank holds the same parameters bit for
    bit."""
    _, n = REPLICAS[name]
    group = {4: "four", 2: "two", 8: "eight"}[n]
    assert len(ranks[group]) == n
    for rank in ranks[group]:
        got = rank["steps"][name]
        assert got["token_axes"] == ("data",)
        _held(got, name, "mlp")
    assert len({rank["steps"][name]["digest"] for rank in ranks[group]}) == 1


# -- (d) rows over data and seq ----------------------------------------------------------------
def test_rows_over_data_and_seq_match_jax(ranks):
    """``P(("data", "seq"))`` on dim 0 of ``data=2 x seq=2``: four row
    blocks in the JAX device order; ``leading_multiple`` and ``pad_batch``
    of a 6-row batch equal the JAX package's, each rank takes its block of
    the padded rows, and three steps equal the JAX package's and the
    one-device step."""
    batch, _ = _inputs()["mlp"]
    jdp, _, _ = _jax_dp("data_seq_rows", _mlp_run(DATA_SEQ, specs=[(("data", "seq"),)] * 2))
    padded, mask = jdp.pad_batch(*(b[:PAD_ROWS] for b in batch))
    assert jdp.leading_multiple(*batch) == 4 and mask.shape == (8,)
    for r, rank in enumerate(ranks["four"]):
        got = rank["steps"]["data_seq_rows"]
        assert got["token_axes"] == ("data", "seq") and got["leading_multiple"] == 4
        tpad, tmask, rows = got["pad"]
        np.testing.assert_array_equal(tmask, mask)
        c = _coords(DATA_SEQ, r)
        block = c["data"] * 2 + c["seq"]
        for a, b, mine in zip(tpad, padded, rows):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(mine, b[2 * block:2 * block + 2])
        _held(got, "data_seq_rows", "mlp")


# -- (e) the Trainer ---------------------------------------------------------------------------
def test_trainer_resume_on_model_expert_mesh(ranks):
    """``Trainer(parallel=True)`` of the MoE LM on ``data=1 x model=2 x
    expert=2`` with ``P(("data", "expert"))`` and sharded async checkpoints
    every 2 steps: the run resumed from the checkpoint after one epoch
    equals the uninterrupted two epochs bit for bit, with the same
    losses."""
    for rank in ranks["four"]:
        got = rank["trainer"]
        assert got["step"] == 4 and got["resumed_equal"]
        assert np.ravel(got["resumed_losses"]).tolist() == np.ravel(
            got["whole_losses"])[2:].tolist()
        assert all(np.isfinite(np.ravel(got["whole_losses"])))
        assert got["local_shapes"]["layer_0/moe_ffn/w_in"][0] * 2 == cases.MOE_LM["moe_experts"]


# -- the spec arithmetic --------------------------------------------------------------------
@pytest.mark.parametrize("axes,spec", [
    (dict(data=2, expert=2), (("data", "expert"), None)),
    (dict(data=2, expert=2), (("expert", "data"), None)),
    (dict(data=2, model=2, seq=2), ("data", ("seq", "model"))),
    (dict(data=2, tp=2), (None, "tp")),
])
def test_stored_windows_follow_jax_device_order(monkeypatch, axes, spec):
    """Each rank's window of a parameter stored over an axis or a tuple of
    axes is the block the JAX package's ``NamedSharding`` puts on the
    device at that rank's mesh position (row-major over a tuple's axes);
    ``cut_block`` cuts it, and a block whose stored dims the step gathered
    (held dims still cut) is taken by ``Model.apply``."""
    from jax.sharding import NamedSharding as JNamedSharding

    from paddle_tpu_torch import framework
    from paddle_tpu_torch.parallel import make_mesh, mesh as tmesh, sharding

    n = int(np.prod(list(axes.values())))
    shape = (8, 4)
    mesh = make_mesh(**axes, devices=list(range(n)))
    jmesh = jmake_mesh(**axes, devices=jax.devices()[:n])
    want = JNamedSharding(jmesh, JP(*spec)).devices_indices_map(shape)
    whole = torch.arange(32.0).reshape(shape)
    sh = sharding.NamedSharding(mesh, sharding.P(*spec))
    dims = sharding.block_dims(sh)
    assert sharding.split_blocks({"w": sh}) == ({}, {"w": dims})
    for rank, device in enumerate(jmesh.devices.flat):
        monkeypatch.setattr(tmesh, "process_rank", lambda r=rank: r)
        window = sharding.block_window(shape, dims, mesh)
        assert window == tuple((s.start or 0, s.stop or size)
                               for s, size in zip(want[device], shape)), (rank, window)
        cut = sharding.cut_block(whole, dims, mesh)
        assert torch.equal(cut, whole[tuple(slice(a, b) for a, b in window)])
    held = sharding.NamedSharding(make_mesh(data=2, model=2, devices=[0, 1, 2, 3]),
                                  sharding.P("data", "model"))
    assert sharding.split_blocks({"w": held}) == ({"w": [(1, "model")]}, {"w": [(0, "data")]})
    with held.mesh:  # dim 0 gathered whole for the step, dim 1 this rank's block
        assert framework._is_local_block((8, 2), shape, ("data", "model"))
        assert framework._is_local_block((4, 2), shape, ("data", "model"))
        assert not framework._is_local_block((8, 3), shape, ("data", "model"))

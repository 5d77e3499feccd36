"""The port's tensor parallelism over ``model`` on gloo ranks (CPU) against
the JAX package: Megatron's column- and row-parallel projections
(``layers.fc``), the embedding split over d_model, each rank's heads
through the attention (GQA with ``H_kv`` divisible by ``model``, rope,
swiglu, ragged ``kv_len``), the vocabulary-split logits gathered whole,
``DataParallel`` on ``data=1 x model=2`` and ``data=2 x model=2`` (ZeRO-1
too) for the LM, the NMT Transformer and an unannotated MLP (replicated
over ``model``), dropout masks drawn whole and cut to each rank's block,
``Trainer(parallel=True)`` resuming bit for bit, sharded checkpoints
read across the packages (a resharded restore included), an FFN width
that ``model`` does not divide (fc1 and fc2 held whole, as GSPMD degrades
them), and the norm clips by the whole gradients' norms.

The JAX side is the single-device step on the global batch (GSPMD
preserves the program's semantics on any mesh), its checkpoint the JAX
``DataParallel``'s on ``data=2 x model=2``. The port's ranks run one spawn
of two gloo ranks and one of four (rank bodies in
``torch_parallel_cases.py``); the port runs the flash route (its plain
version on CPU tensors) where the JAX side composes attention.

Tolerances are the JAX tests': forward rtol 2e-4, atol 2e-5; gradients
rtol 2e-4, atol 2e-4; LM losses rtol 1e-4 (1e-5 over three steps, as
``test_torch_data_parallel.py``); parameters after three Adam steps atol
1e-4, the attention k biases (zero gradient in exact arithmetic) at the
scheduled rates' sum.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import torch_parallel_cases as cases
from paddle_tpu import checkpoint_sharded as jcks
from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.parallel import DataParallel as JDataParallel
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.parallel import launch

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
M2, D2M2 = dict(data=1, model=2), dict(data=2, model=2)

# name -> (kind, kwargs, ragged)
CONFIGS = {
    "lm": ("lm", dict(cases.TP_LM, flash=True), False),
    "lm_gqa_rope_swiglu": ("lm", dict(cases.TP_LM, flash=True, num_kv_heads=2,
                                      pos_encoding="rope", ffn_activation="swiglu"), False),
    "lm_ragged": ("lm", dict(cases.TP_LM, flash=True), True),
    "nmt": ("nmt", dict(cases.TP_NMT, flash=True), False),
    "mlp": ("mlp", {}, False),
    # d_inner odd: fc1's columns and fc2's rows stay whole on model=2
    "lm_odd_inner": ("lm", dict(cases.TP_LM, flash=True, d_inner=63), False),
    # clipped SGD (class, clip_norm, rate): the clips bind at these norms
    "lm_clip": ("lm", dict(cases.TP_LM, flash=True,
                           grad_clip=("GradientClipByGlobalNorm", 0.01, 10.0)), False),
    "lm_clip_norm": ("lm", dict(cases.TP_LM, flash=True,
                                grad_clip=("GradientClipByNorm", 0.002, 10.0)), False),
}


@pytest.fixture(scope="module", autouse=True)
def jax_composed():
    saved = (jconfig.flags().use_flash_attention, jconfig.flags().use_bf16_compute)
    jconfig.set_flags(use_flash_attention=False, use_bf16_compute=False)
    yield
    jconfig.set_flags(use_flash_attention=saved[0], use_bf16_compute=saved[1])


def _plain_kw(kw):
    return {k: v for k, v in kw.items() if k not in ("flash", "grad_clip")}


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(batch, params) as numpy: the batch from a numpy seed, the weights
    from the port's seeded init."""
    kind, kw, ragged = CONFIGS[name]
    rng = np.random.RandomState(3)
    if kind == "mlp":
        batch = (rng.randn(8, 3).astype(np.float32), rng.randn(8).astype(np.float32))
    else:
        spec = tmodels.get_model("transformer_lm" if kind == "lm" else "transformer",
                                 device="cpu", **_plain_kw(kw))
        batch = tuple(b.numpy() for b in spec.synth_batch(4, rng))
        if ragged:
            batch += (np.array([16, 5, 11, 2], np.int32),)
    model, _ = cases.mp_model(kind, kw)
    v = model.init(0, *(torch.from_numpy(b) for b in batch), device="cpu")
    return batch, {k: t.numpy() for k, t in v.params.items()}


def _jax_model(name):
    kind, kw, _ = CONFIGS[name]
    if kind == "mlp":
        return jpt.build(cases.mlp_net(jpt.layers, jpt.ops, jnp.mean), name="mlp"), \
            lambda: jpt.optimizer.Adam(cases.MLP_LR)
    spec = jmodels.get_model("transformer_lm" if kind == "lm" else "transformer",
                             **_plain_kw(kw))
    if "grad_clip" in kw:
        return spec.model, cases.clipped_sgd(kw["grad_clip"], jpt)
    return spec.model, spec.optimizer


def _jax_grads(name, batch, params):
    """The JAX package's training loss, logits and every gradient."""
    model, _ = _jax_model(name)

    def loss(p):
        (l, _, logits), _ = model.apply(JVariables(p, {}), *batch, is_train=True)
        return l, logits

    (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(a) for k, a in params.items()})
    return float(value), np.asarray(logits), {k: np.asarray(g) for k, g in grads.items()}


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    """``STEPS`` single-device steps of the JAX package on the global batch."""
    batch, params = _inputs(name)
    model, opt_fn = _jax_model(name)
    opt = opt_fn()
    step = jax.jit(opt.minimize(model))
    v = JVariables({k: jnp.asarray(a) for k, a in params.items()}, {})
    o = opt.create_state(v.params)
    losses = []
    for _ in range(cases.STEPS):
        out = step(v, o, *batch)
        v, o = out.variables, out.opt_state
        losses.append(float(out.loss))
    return losses, {k: np.asarray(a) for k, a in v.params.items()}


APPLY = ("lm", "lm_gqa_rope_swiglu", "nmt", "lm_odd_inner")
DP2 = ("lm", "nmt", "mlp", "lm_odd_inner", "lm_clip")
DP4 = ("lm", "lm_zero1", "lm_ragged", "nmt", "lm_clip_norm")
DROPOUT = {"lm_dropout": ("lm", dict(cases.TP_LM, attn_dropout=0.1, relu_dropout=0.1,
                                     residual_dropout=0.1)),
           "nmt_dropout": ("nmt", dict(cases.TP_NMT, attn_dropout=0.1, relu_dropout=0.1,
                                       residual_dropout=0.1))}


def _jax_dp_checkpoint(root, batch, params):
    """The JAX DataParallel on ``data=2 x model=2``: three steps of the LM
    from ``params``, its state saved sharded in ``root``."""
    mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    spec = jmodels.get_model("transformer_lm", **cases.TP_LM)
    dp = JDataParallel(spec.model, spec.optimizer(), mesh=mesh, donate=False)
    v, o = dp.init(jax.random.PRNGKey(0), *batch, variables=JVariables(
        {k: jnp.asarray(a) for k, a in params.items()}, {}))
    for _ in range(cases.STEPS):
        out = dp.step(v, o, *dp.put_batch(*batch))
        v, o = out.variables, out.opt_state
    jcks.save_sharded(root, (v, o), step=cases.STEPS)
    return dp, v, o


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    inputs = {name: _inputs(name) for name in CONFIGS}
    apply_cases = {n: (CONFIGS[n][0], CONFIGS[n][1], *inputs[n]) for n in APPLY}

    def run(axes, name, zero=False):
        key = "lm" if name == "lm_zero1" else name
        kind, kw, _ = CONFIGS[key]
        return (axes, kind, kw, zero, *inputs[key])

    drop_cases = {}
    for name, (kind, kw) in DROPOUT.items():
        batch, params = inputs["lm" if kind == "lm" else "nmt"]
        drop_cases[name] = (M2, kind, kw, batch, params)
    lm_batch, lm_params = inputs["lm"]
    trainer_batches = [lm_batch] + [tuple(b.numpy() for b in tmodels.get_model(
        "transformer_lm", device="cpu", **cases.TP_LM).synth_batch(4, np.random.RandomState(s)))
        for s in (21, 22, 23)]
    jax_root = str(root / "jax")
    jdp, jv, jo = _jax_dp_checkpoint(jax_root, lm_batch, lm_params)
    two = {
        "init": ("mp_init_blocks", ("lm", CONFIGS["lm"][1], inputs["lm"][0])),
        "init_odd": ("mp_init_blocks", ("lm", CONFIGS["lm_odd_inner"][1],
                                        inputs["lm_odd_inner"][0])),
        "apply": ("mp_apply", (M2, apply_cases)),
        "dp": ("mp_dp_steps", ({n: run(M2, n) for n in DP2},)),
        "dropout": ("mp_dropout", (drop_cases,)),
        "trainer": ("mp_trainer", ((str(root / "a"), str(root / "b")), trainer_batches,
                                   lm_params, jax_root, M2)),
    }
    four = {
        "dp": ("mp_dp_steps", ({n: run(D2M2, n, zero=n == "lm_zero1") for n in DP4},)),
        "trainer": ("mp_trainer", ((str(root / "c"), str(root / "d")), trainer_batches,
                                   lm_params, jax_root, D2M2)),
    }
    got2 = launch.spawn(cases.calls, 2, args=(two,), device="cpu")
    got4 = launch.spawn(cases.calls, 4, args=(four,), device="cpu")
    return dict(two=got2, four=got4, inputs=inputs, root=root, jax_state=(jdp, jv, jo))


def test_init_under_model_mesh_takes_blocks_of_the_one_device_init(tp):
    """``Model.init`` inside ``with mesh:`` on ``model=2``: every parameter
    annotated over ``model`` (the embedding, q/k/v, out, fc1, fc2 and the
    logits) is this rank's block, bit-equal to the slice of the
    one-device init; the rest is whole."""
    for rank in tp["two"]:
        got = rank["init"]
        assert got["equal"]
        assert "emb/embedding/word_emb" in got["split"] and "project/logits/w" in got["split"]
        assert "layer_0/ffn/fc2/w" in got["split"] and "layer_0/ffn/fc1/b" not in got["split"]
        # an FFN width the axis does not divide: fc1 and fc2 whole, the rest split
        odd = rank["init_odd"]
        assert odd["equal"] and "layer_0/self_attn/q/w" in odd["split"]
        assert not {"layer_0/ffn/fc1/w", "layer_0/ffn/fc2/w"} & set(odd["split"])


def _blocks(name, want, shape, rank):
    """This rank's block of the whole array ``want`` (``model`` is the last
    mesh axis: its index is the rank's, modulo 2)."""
    m = rank % 2
    for dim, (w, s) in enumerate(zip(want.shape, shape)):
        if w != s:
            want = np.take(want, range(m * s, (m + 1) * s), axis=dim)
    return want


@pytest.mark.parametrize("name", APPLY)
def test_apply_on_model2_matches_jax(tp, name):
    """``Model.apply`` with each rank's blocks on ``model=2``: the loss, the
    logits (gathered whole on both ranks), every gradient (each rank's
    block of the split parameters, the whole of the replicated ones)
    against the JAX package's single-device values."""
    batch, params = tp["inputs"][name]
    loss, logits, grads = _jax_grads(name, batch, params)
    # the NMT's flash route masks padding structurally, the JAX composed
    # route additively: the logits of the padded target rows differ (they
    # carry no loss), the others agree
    valid = ~batch[5][..., None] if CONFIGS[name][0] == "nmt" else True
    for r, rank in enumerate(tp["two"]):
        got = rank["apply"][name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(np.where(valid, got["logits"], 0), np.where(valid, logits, 0),
                                   err_msg=name, **FWD)
        assert set(got["grads"]) == set(grads)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, _blocks(name, grads[k], got["shapes"][k], r),
                                       err_msg=f"{name} {k}", **GRAD)
    # the embedding, q and out are blocks (columns, columns, rows)
    got = tp["two"][0]["apply"][name]
    emb = "emb/embedding/word_emb" if CONFIGS[name][0] == "lm" else "src_emb/embedding/word_emb"
    assert got["shapes"][emb][1] * 2 == params[emb].shape[1]
    w = "layer_0/self_attn/q/w" if CONFIGS[name][0] == "lm" else "enc_layer_0/self_attn/q/w"
    assert got["shapes"][w][1] * 2 == params[w].shape[1]
    assert got["shapes"][w.replace("/q/", "/out/")][0] * 2 == params[w].shape[0]
    if name == "lm_odd_inner":  # fc1 and fc2 whole: the plain FFN on every rank
        for k in ("layer_0/ffn/fc1/w", "layer_0/ffn/fc2/w"):
            assert got["shapes"][k] == params[k].shape, k


def _clip_binds(name, batch, params):
    """Whether a clipped case's clip scales the first step's gradients: the
    global norm, or every split weight's norm, above ``clip_norm``."""
    kind, norm, _ = CONFIGS[name][1]["grad_clip"]
    _, _, grads = _jax_grads(name, batch, params)
    sq = {k: float(np.sum(np.square(g.astype(np.float64)))) for k, g in grads.items()}
    if kind == "GradientClipByGlobalNorm":
        return sum(sq.values()) ** 0.5 > norm
    return all(sq[k] ** 0.5 > norm for k in ("layer_0/self_attn/q/w", "layer_0/ffn/fc2/w",
                                             "emb/embedding/word_emb"))


def _lr_sum(name):
    """What three steps at the scheduled rates can move a parameter."""
    _, opt = cases.mp_model(CONFIGS[name][0], CONFIGS[name][1])
    o = opt()
    return sum(o.scheduler(t) for t in range(cases.STEPS))


def _held(got, losses, params, lr):
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for k, a in params.items():
        atol = max(lr, 1e-4) if k.endswith("self_attn/k/b") else 1e-4
        np.testing.assert_allclose(got["state"][0][k], a, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("where,name", [("two", n) for n in DP2] + [("four", n) for n in DP4])
def test_dataparallel_on_model_axis_matches_jax_step(tp, where, name):
    """Three steps of ``DataParallel`` on ``model=2`` (two ranks) or
    ``data=2 x model=2`` (four; ZeRO-1 too) against the JAX single-device
    step on the global batch; the ranks of a ``model`` block hold
    bit-equal parameters, the batch outputs are the global batch's (the
    logits gathered whole), each rank holds half of a split weight (the
    FFN whole where ``model`` does not divide its width), ``place_state``
    cuts ``full_state``'s whole tree back to its blocks, and a clipped SGD
    clips by the whole gradients' norms (the clip binds)."""
    key = "lm" if name == "lm_zero1" else name
    batch, params = _inputs(key)
    losses, want = _jax_steps(key)
    ranks = tp[where]
    for rank in ranks:
        got = rank["dp"][name]
        _held(got, losses, want, _lr_sum(key))
        assert got["placed_round_trip"]  # place_state(full_state(...)) gives the blocks back
        assert got["eval_shapes"][-1][0] == batch[0].shape[0]
        if CONFIGS[key][0] == "lm":
            assert got["eval_shapes"][-1] == (4, cases.TP_LM["seq_len"], cases.TP_LM["vocab"])
            d_inner = CONFIGS[key][1]["d_inner"]
            assert got["local_shapes"]["layer_0/ffn/fc1/w"][1] == (
                d_inner // 2 if d_inner % 2 == 0 else d_inner)
        if key == "mlp":  # unannotated: replicated over model
            assert got["local_shapes"] == {k: a.shape for k, a in params.items()}
    if "grad_clip" in CONFIGS[key][1]:
        assert _clip_binds(key, batch, params)
    for r, rank in enumerate(ranks):
        assert rank["dp"][name]["digest"] == ranks[r % 2]["dp"][name]["digest"]
    if name == "lm_zero1":  # slots of the replicated parameters split over data
        for rank in ranks:
            plain, zero = rank["dp"]["lm"], rank["dp"]["lm_zero1"]
            assert zero["losses"] == plain["losses"] and zero["digest"] == plain["digest"]
            assert zero["slot_bytes"] < plain["slot_bytes"]


@pytest.mark.parametrize("name", list(DROPOUT))
def test_dropout_masks_on_model2_equal_one_device(tp, name):
    """With the published dropouts, a step on ``model=2`` equals the port's
    one-device step drawn from the same generator (each mask drawn at the
    whole shape, cut to the rank's heads or columns); another stream moves
    the loss, so the masks matter."""
    for rank in tp["two"]:
        got = rank["dropout"][name]
        np.testing.assert_allclose(got["loss"], got["ref_loss"], rtol=1e-5)
        assert abs(got["other_mask_loss"] - got["ref_loss"]) > 1e-3
        assert got["max_diff"] <= 1e-5


@pytest.mark.parametrize("where", ["two", "four"])
def test_trainer_on_model_axis_resumes_and_checkpoints_cross_packages(tp, where):
    """``Trainer(parallel=True)`` on ``model=2`` and ``data=2 x model=2``:
    the run resumed from its sharded checkpoint equals the uninterrupted one
    bit for bit; that checkpoint loads in the JAX package (into its
    ``data=2 x model=2`` layout and into a whole tree: a resharded restore),
    and the JAX package's ``data=2 x model=2`` checkpoint loads at the
    port's layout (at ``model=2`` a resharded restore)."""
    ranks = tp[where]
    for rank in ranks:
        t = rank["trainer"]
        assert t["step"] == 8 and t["resumed_equal"]
        assert t["resumed_losses"] == t["whole_losses"][4:]
        assert t["local_shapes"]["layer_0/ffn/fc2/w"][0] * 2 == cases.TP_LM["d_inner"]
    full = ranks[0]["trainer"]["state"]
    root = str(tp["root"] / ("a" if where == "two" else "c"))
    jdp, jv, jo = tp["jax_state"]
    for target in ((jv, jo), jdp.state_template(jv, jo)):
        (lv, lo), manifest = jcks.load_sharded(root, target)
        assert manifest["step"] == 8 and manifest["num_processes"] == len(ranks)
        for k, a in full[0].items():
            np.testing.assert_array_equal(np.asarray(lv.params[k]), a, err_msg=k)
        for s, d in lo.slots.items():
            for k, a in d.items():
                np.testing.assert_array_equal(np.asarray(a), full[2][s][k], err_msg=k)
    for rank in ranks:
        state, step, mstep = rank["trainer"]["jax_loaded"]
        assert step == mstep == cases.STEPS
        assert rank["trainer"]["jax_loaded_shapes"]["layer_0/self_attn/q/w"][1] * 2 == \
            cases.TP_LM["d_model"]
        for k, a in jv.params.items():
            np.testing.assert_array_equal(state[0][k], np.asarray(a), err_msg=k)
        for s, d in jo.slots.items():
            for k, a in d.items():
                np.testing.assert_array_equal(state[2][s][k], np.asarray(a), err_msg=k)

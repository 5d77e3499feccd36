"""The port's composed mesh axes on gloo ranks (CPU) against the JAX
package, which composes them through GSPMD:

- the LM with ``pipe_mesh`` on ``pipe=2 x model=2``: outside the stages
  the embedding and the logits split over ``model``; inside them each rank
  runs its stage on its rows of every microbatch with the stage's
  parameters whole (``paddle_tpu/parallel/pipeline.py:119-135``). Its loss,
  logits and every gradient on every rank (a block's for its block), with
  and without ``remat``, against the JAX LM on its 8-device ``pipe=2 x
  model=2 x data=2`` mesh; ``DataParallel`` on that mesh (plain and with a
  clipped SGD, which clips by the whole gradients' norm), three steps,
  against the JAX one-device step on the global batch;
- the LM with ``ring_mesh``/``ulysses_mesh`` on ``seq=2 x model=2``: the
  ring and Ulysses run within the ``seq`` group of the ranks sharing a
  ``model`` coordinate on that rank's heads; global arrays against the JAX
  LM on ``seq=2 x model=2 x data=2`` (whose core runs whole heads), and
  ``DataParallel`` with ``P("data", "seq")``, three Adam steps, against the
  JAX one-device step. Two heads (one a rank, which ``seq`` does not
  split) fall back to whole heads, as the JAX package runs them;
- ZeRO-1 on ``expert=2`` (two ranks) and ``data=2 x expert=2`` (four): the
  slots of the experts keep their blocks, the others split over ``data``
  (``paddle_tpu/parallel/data_parallel.py:221-229``); the step equals the
  step without ZeRO-1 bit for bit and the JAX one-device step;
- ``Trainer(parallel=True)`` on ``pipe=2 x model=2``, ``seq=2 x model=2``
  (ring) and ``expert=2`` (ZeRO-1) against the JAX one-device steps, and
  the ``pipe=2 x model=2`` sharded checkpoints read across the packages
  and by one port rank;
- what stays refused, with the JAX package's message where it has one
  (the composed meshes' process groups: ``test_torch_moe.py``).

One spawn of four gloo ranks runs every four-rank case and one of two
ranks the ``expert=2`` ones (rank bodies in ``torch_parallel_cases.py``).
The JAX side composes attention; the port runs its flash route (the plain
version on CPU tensors). Tolerances are ``test_torch_pipeline.py``'s:
forward rtol 2e-4, atol 2e-5; gradients rtol 2e-4, atol 2e-4; losses rtol
1e-4 (1e-5 over three steps); parameters after three steps atol 1e-4, the
attention k biases (zero gradient in exact arithmetic) at the scheduled
rates' sum.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import concurrent.futures
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
from paddle_tpu_torch import checkpoint_sharded as tcks
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import ParamAttr, Variables
from paddle_tpu_torch.framework import build as tbuild
from paddle_tpu_torch.parallel import DataParallel, P, launch, make_mesh, sharding

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
PM = dict(pipe=2, model=2, data=1)
SM = dict(data=1, seq=2, model=2)
E2, D2E2 = dict(data=1, expert=2), dict(data=2, expert=2)
SEQ_SPECS = [("data", "seq"), ("data", "seq")]
CLIP = ("GradientClipByGlobalNorm", 0.01, 10.0)


@pytest.fixture(scope="module", autouse=True)
def jax_composed():
    saved = (jconfig.flags().use_flash_attention, jconfig.flags().use_bf16_compute)
    jconfig.set_flags(use_flash_attention=False, use_bf16_compute=False)
    yield
    jconfig.set_flags(use_flash_attention=saved[0], use_bf16_compute=saved[1])


def _lm_kw(**kw):
    return dict(cases.PIPE_LM, flash=True, **kw)


def _plain(kw):
    return {k: v for k, v in kw.items()
            if k not in ("flash", "seq_mode", "pipe_n_micro", "remat", "grad_clip")}


# name -> (mesh axes, the port's LM kwargs, rows): Model.apply on the global
# batch on every rank (rows 16 for the pipeline, 8 for the ring and Ulysses)
APPLY = {
    "pipe_model": (PM, _lm_kw(pipe_n_micro=4), 16),
    "pipe_model_remat": (PM, _lm_kw(pipe_n_micro=4, remat=True), 16),
    "ring_model": (SM, _lm_kw(seq_mode="ring"), 8),
    "ulysses_model": (SM, _lm_kw(seq_mode="ulysses"), 8),
    # one head a rank, which seq=2 does not split: whole heads in the core
    "ulysses_whole_heads": (SM, _lm_kw(seq_mode="ulysses", num_heads=2), 8),
}
# name -> (mesh axes, LM kwargs, batch specs, ZeRO-1, rows): three steps (on
# pipe=2 x model=2, 4 microbatches of 2 rows: one row a rank in a stage)
DP = {
    "pipe_model": (PM, _lm_kw(pipe_n_micro=4), None, False, 8),
    "pipe_model_clip": (PM, _lm_kw(pipe_n_micro=4, grad_clip=CLIP), None, False, 8),
    "ring_model": (SM, _lm_kw(seq_mode="ring"), SEQ_SPECS, False, 8),
    "ulysses_model": (SM, _lm_kw(seq_mode="ulysses"), SEQ_SPECS, False, 8),
}
MOE_KW = dict(cases.MOE_LM, moe_router="top1", moe_capacity_factor=0.75)
# name -> (mesh axes, ZeRO-1, ranks)
ZERO = {"expert2": (E2, False, 2), "expert2_zero1": (E2, True, 2),
        "data2_expert2": (D2E2, False, 4), "data2_expert2_zero1": (D2E2, True, 4)}


@functools.lru_cache(maxsize=None)
def _inputs():
    """Two 16-row batches (numpy seeds 0 and 1) and the port's seeded init
    of the LM; the MoE LM's batch, second batch and init."""
    spec = tmodels.get_model("transformer_lm", device="cpu", **cases.PIPE_LM)
    batches = [tuple(b.numpy() for b in spec.synth_batch(16, np.random.RandomState(s)))
               for s in (0, 1)]
    params = {k: t.numpy() for k, t in spec.model.init(
        0, *(torch.from_numpy(b) for b in batches[0]), device="cpu").params.items()}
    moe = tmodels.get_model("transformer_lm", device="cpu", **MOE_KW)
    moe_batches = [tuple(b.numpy() for b in moe.synth_batch(4, np.random.RandomState(s)))
                   for s in (17, 18)]
    moe_params = {k: t.numpy() for k, t in moe.model.init(
        0, *(torch.from_numpy(b) for b in moe_batches[0]), device="cpu").params.items()}
    return batches, params, moe_batches, moe_params


def _rows(batch, n):
    return tuple(b[:n] for b in batch)


def _jax_state(params):
    return JVariables({k: jnp.asarray(a) for k, a in params.items()}, {})


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    """The JAX LM of an APPLY case on its 8-device composed mesh (the plain
    LM with two heads for ``ulysses_whole_heads``): the training loss,
    the logits and every gradient."""
    axes, kw, rows = APPLY[name]
    batches, params, _, _ = _inputs()
    batch = _rows(batches[0], rows)
    mesh_kw = {}
    if "seq_mode" in kw and name != "ulysses_whole_heads":
        mesh_kw[f"{kw['seq_mode']}_mesh"] = jmake_mesh(seq=2, model=2, data=2)
    elif "pipe_n_micro" in kw:
        mesh_kw = dict(pipe_mesh=jmake_mesh(pipe=2, model=2, data=2),
                       pipe_n_micro=kw["pipe_n_micro"])
    spec = jmodels.get_model("transformer_lm", **mesh_kw, **_plain(kw))

    def loss(p):
        (value, _, logits), _ = spec.model.apply(JVariables(p, {}), *batch, is_train=True)
        return value, logits

    (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        _jax_state(params).params)
    return float(value), np.asarray(logits), {k: np.asarray(g) for k, g in grads.items()}


@functools.lru_cache(maxsize=None)
def _jax_step(key):
    """The JAX one-device step (jitted once) and its optimizer for ``key``:
    ``("lm", rows)``, ``("lm_clip", rows)`` or ``("moe",)``."""
    if key[0] == "moe":
        spec = jmodels.get_model("transformer_lm", **MOE_KW)
        opt = spec.optimizer()
    else:
        spec = jmodels.get_model("transformer_lm", **cases.PIPE_LM)
        opt = cases.clipped_sgd(CLIP, jpt)() if key[0] == "lm_clip" else spec.optimizer()
    return jax.jit(opt.minimize(spec.model)), opt


@functools.lru_cache(maxsize=None)
def _jax_steps(key, n_steps, which=(0, 0, 0)):
    """The JAX one-device steps of ``key`` on the batches ``which`` (one a
    step, indices into the inputs' batches, cut to ``key``'s rows): the
    losses and the parameters after them."""
    batches, params, moe_batches, moe_params = _inputs()
    if key[0] == "moe":
        batches, params = moe_batches, moe_params
    step, opt = _jax_step(key)
    v = _jax_state(params)
    o = opt.create_state(v.params)
    losses = []
    for i in which[:n_steps]:
        b = batches[i] if key[0] == "moe" else _rows(batches[i], key[1])
        out = step(v, o, *b)
        v, o = out.variables, out.opt_state
        losses.append(float(out.loss))
    return losses, {k: np.asarray(a) for k, a in v.params.items()}


def _lr_sum(opt, n_steps=cases.STEPS):
    """What ``n_steps`` at the scheduled rates can move a parameter."""
    return sum(opt.scheduler(t) for t in range(n_steps))


def _jax_checkpoint(root):
    """The JAX DataParallel's state on ``pipe=2 x model=2`` (its 4-device
    mesh, the LM with that pipe_mesh), with seeded slots, saved sharded at
    step 3; returns the DataParallel and the state."""
    batches, params, _, _ = _inputs()
    mesh = jmake_mesh(pipe=2, model=2, data=1, devices=jax.devices()[:4])
    spec = jmodels.get_model("transformer_lm", pipe_mesh=mesh, pipe_n_micro=4,
                             **cases.PIPE_LM)
    dp = JDataParallel(spec.model, spec.optimizer(), mesh=mesh, donate=False)
    v, o = dp.init(jax.random.PRNGKey(0), *batches[0], variables=_jax_state(params))
    rng = np.random.RandomState(9)
    slots = {s: {k: jax.device_put(rng.randn(*a.shape).astype(np.float32), a.sharding)
                 for k, a in d.items()} for s, d in o.slots.items()}
    o = o._replace(step=jnp.int32(cases.STEPS), slots=slots)
    jcks.save_sharded(root, (v, o), step=cases.STEPS)
    return dp, v, o


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("composed")
    batches, params, moe_batches, moe_params = _inputs()
    jax_root = str(root / "jax")
    jax_state = _jax_checkpoint(jax_root)

    def apply_cases(axes):
        return {n: ("lm", kw, _rows(batches[0], r), params)
                for n, (a, kw, r) in APPLY.items() if a == axes}

    def dp_runs(*names):
        return {n: (DP[n][0], "lm", DP[n][1], DP[n][3], _rows(batches[0], DP[n][4]), params)
                for n in names}

    seq_runs = {n: (DP[n][0], DP[n][1], DP[n][2], DP[n][3], _rows(batches[0], DP[n][4]), params)
                for n in ("ring_model", "ulysses_model")}

    def zero_runs(n_ranks):
        return {n: (axes, dict(MOE_KW), None, zero, moe_batches[0], moe_params)
                for n, (axes, zero, r) in ZERO.items() if r == n_ranks}

    four = {
        "apply_pm": ("mp_apply", (PM, apply_cases(PM))),
        "apply_sm": ("mp_apply", (SM, apply_cases(SM))),
        "dp_pm": ("mp_dp_steps", (dp_runs("pipe_model", "pipe_model_clip"),)),
        "dp_sm": ("sp_dp_steps", (seq_runs,)),
        "zero": ("sp_dp_steps", (zero_runs(4),)),
        "trainer_pm": ("cx_trainer", (str(root / "pm"), PM, APPLY["pipe_model"][1], None, False,
                                      [_rows(b, 8) for b in batches], jax_root)),
        "trainer_ring": ("cx_trainer", (str(root / "ring"), SM, APPLY["ring_model"][1],
                                        SEQ_SPECS, False, [_rows(b, 8) for b in batches],
                                        None)),
    }
    two = {
        "zero": ("sp_dp_steps", (zero_runs(2),)),
        "trainer": ("cx_trainer", (str(root / "e2"), E2, dict(MOE_KW), None, True,
                                   list(moe_batches), None)),
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(lambda: (launch.spawn(cases.calls, 4, args=(four,), device="cpu"),
                                   launch.spawn(cases.calls, 2, args=(two,), device="cpu")))
        _jax_references()  # meanwhile: the JAX side's compiles overlap the ranks' work
        got4, got2 = job.result()
    return dict(four=got4, two=got2, root=root, jax_state=jax_state)


def _jax_references():
    """Every JAX reference the tests read (each cached)."""
    for name in APPLY:
        _jax_grads(name.replace("_remat", ""))
    for _, kw, _, _, rows in DP.values():
        _jax_steps(("lm_clip" if "grad_clip" in kw else "lm", rows), cases.STEPS)
    _jax_steps(("moe",), cases.STEPS)
    for key in (("lm", 8), ("moe",)):
        _jax_steps(key, 2, (0, 1))


def _block(want, shape, m):
    """Model block ``m`` of the whole array ``want`` for a rank holding
    ``shape``."""
    for dim, (w, s) in enumerate(zip(want.shape, shape)):
        if w != s:
            want = np.take(want, range(m * s, (m + 1) * s), axis=dim)
    return want


def _model_index(axes, rank):
    """This rank's ``model`` coordinate (the last mesh axis varies
    fastest)."""
    names = list(axes)
    coords = np.argwhere(np.arange(4).reshape([axes[a] for a in names]) == rank)[0]
    return int(coords[names.index("model")])


@pytest.mark.parametrize("name", list(APPLY))
def test_apply_on_composed_mesh_matches_jax(ranks, name):
    """``Model.apply`` on the global batch on every rank of ``pipe=2 x
    model=2`` or ``seq=2 x model=2``: the loss, the logits and every
    parameter's gradient (a block's for its block, whole on every stage and
    every ``seq`` rank) against the JAX LM on its composed mesh; the q
    projection and the embedding are held as blocks."""
    axes, kw, rows = APPLY[name]
    # remat recomputes the same function: the plain pipeline's reference
    loss, logits, grads = _jax_grads(name.replace("_remat", ""))
    key = "apply_pm" if axes == PM else "apply_sm"
    _, params, _, _ = _inputs()
    for r, rank in enumerate(ranks["four"]):
        got = rank[key][name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(got["logits"], logits, err_msg=name, **FWD)
        assert set(got["grads"]) == set(grads)
        m = _model_index(axes, r)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, _block(grads[k], got["shapes"][k], m),
                                       err_msg=f"{name} {k}", **GRAD)
        assert got["shapes"]["layer_0/self_attn/q/w"][1] * 2 == params["layer_0/self_attn/q/w"].shape[1]
        assert got["shapes"]["emb/embedding/word_emb"][1] * 2 == cases.PIPE_LM["d_model"]


@pytest.mark.parametrize("name", list(DP))
def test_dataparallel_on_composed_mesh_matches_jax_step(ranks, name):
    """Three steps of ``DataParallel`` on ``pipe=2 x model=2`` (Adam, and
    SGD clipped by the global norm, which binds) and on ``seq=2 x model=2``
    (ring, Ulysses; ``P("data", "seq")``) against the JAX one-device step
    on the global batch; the ranks of a ``model`` block hold bit-equal
    parameters, ``place_state`` cuts ``full_state``'s whole tree back to
    the blocks."""
    axes, kw, specs, _, rows = DP[name]
    key = ("lm_clip" if "grad_clip" in kw else "lm", rows)
    losses, want = _jax_steps(key, cases.STEPS)
    lr = _lr_sum(_jax_step(key)[1])
    got_key = "dp_pm" if axes == PM else "dp_sm"
    digests = {}
    for r, rank in enumerate(ranks["four"]):
        got = rank[got_key][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, err_msg=name)
        for k, a in want.items():
            atol = max(lr, 1e-4) if k.endswith("self_attn/k/b") else 1e-4
            np.testing.assert_allclose(got["state"][0][k], a, rtol=0, atol=atol,
                                       err_msg=f"{name} {k}")
        if "placed_round_trip" in got:
            assert got["placed_round_trip"]
        digests.setdefault(_model_index(axes, r), set()).add(got["digest"])
    assert all(len(d) == 1 for d in digests.values()) and len(digests) == 2
    if "grad_clip" in kw:  # the clip binds at the first step
        _, _, grads = _jax_grads("pipe_model")
        norm = sum(float(np.sum(np.square(g.astype(np.float64)))) for g in grads.values()) ** 0.5
        assert norm > CLIP[1]


@pytest.mark.parametrize("name", list(ZERO))
def test_zero1_on_expert_mesh_equals_plain_and_jax(ranks, name):
    """ZeRO-1 beside ``expert``: the experts' slots keep their blocks and
    the replicated parameters' split over ``data``, so the step equals the
    step without ZeRO-1 bit for bit (with fewer slot bytes on ``data=2``),
    and three steps equal the JAX one-device step."""
    axes, zero, n = ZERO[name]
    losses, want = _jax_steps(("moe",), cases.STEPS)
    lr = _lr_sum(_jax_step(("moe",))[1])
    for rank in ranks["four" if n == 4 else "two"]:
        got = rank["zero"][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, err_msg=name)
        for k, a in want.items():
            atol = max(lr, 1e-4) if k.endswith("self_attn/k/b") else 1e-4
            np.testing.assert_allclose(got["state"][0][k], a, rtol=0, atol=atol, err_msg=k)
        assert got["local_shapes"]["layer_0/moe_ffn/w_in"][0] == MOE_KW["moe_experts"] // 2
        if zero:
            plain = rank["zero"][name.replace("_zero1", "")]
            assert got["losses"] == plain["losses"] and got["digest"] == plain["digest"]
            if axes["data"] > 1:
                assert got["slot_bytes"] < plain["slot_bytes"]
            else:
                assert got["slot_bytes"] == plain["slot_bytes"]


def test_trainer_on_composed_meshes_matches_jax_steps(ranks):
    """``Trainer(parallel=True)`` for one epoch of two batches on ``pipe=2
    x model=2``, ``seq=2 x model=2`` (the ring, ``P("data", "seq")``) and
    ``expert=2`` (ZeRO-1): the losses and parameters of the JAX one-device
    steps on those batches, a sharded checkpoint at step 2."""
    runs = [("trainer_pm", ranks["four"], ("lm", 8)), ("trainer_ring", ranks["four"], ("lm", 8)),
            ("trainer", ranks["two"], ("moe",))]
    for key, group, jkey in runs:
        losses, want = _jax_steps(jkey, 2, (0, 1))
        lr = _lr_sum(_jax_step(jkey)[1], 2)
        for rank in group:
            got = rank[key]
            assert got["step"] == 2
            np.testing.assert_allclose(np.ravel(got["losses"]), losses, rtol=1e-5, err_msg=key)
            for k, a in want.items():
                atol = max(lr, 1e-4) if k.endswith("self_attn/k/b") else 1e-4
                np.testing.assert_allclose(got["state"][0][k], a, rtol=0, atol=atol,
                                           err_msg=f"{key} {k}")


def test_pipe_model_checkpoints_cross_packages(ranks):
    """``pipe=2 x model=2``: the port's sharded checkpoint (the Trainer's)
    loads in the JAX package, into its ``pipe=2 x model=2`` layout and into
    a whole tree, and in one port rank (whole tensors), with equal
    parameters and slots; the JAX package's ``pipe=2 x model=2`` checkpoint
    loads at every port rank's layout."""
    full = ranks["four"][0]["trainer_pm"]["state"]
    root = str(ranks["root"] / "pm")
    jdp, jv, jo = ranks["jax_state"]
    for target in ((jv, jo), jdp.state_template(jv, jo)):
        (lv, lo), manifest = jcks.load_sharded(root, target)
        assert manifest["step"] == 2 and manifest["num_processes"] == 4
        for k, a in full[0].items():
            np.testing.assert_array_equal(np.asarray(lv.params[k]), a, err_msg=k)
        for s, d in lo.slots.items():
            for k, a in d.items():
                np.testing.assert_array_equal(np.asarray(a), full[2][s][k], err_msg=k)
    like = (Variables({k: torch.zeros(a.shape) for k, a in full[0].items()}, {}),
            topt.OptState(step=0, slots={s: {k: torch.zeros(a.shape) for k, a in d.items()}
                                         for s, d in full[2].items()}))
    (tv, to), manifest = tcks.load_sharded(root, like)
    assert int(to.step) == 2
    for k, a in full[0].items():
        np.testing.assert_array_equal(tv.params[k].numpy(), a, err_msg=k)
    for s, d in to.slots.items():
        for k, t in d.items():
            np.testing.assert_array_equal(t.numpy(), full[2][s][k], err_msg=k)
    for rank in ranks["four"]:
        state, step, mstep = rank["trainer_pm"]["jax_loaded"]
        assert step == mstep == cases.STEPS
        for k, a in jv.params.items():
            np.testing.assert_array_equal(state[0][k], np.asarray(a), err_msg=k)
        for s, d in jo.slots.items():
            for k, a in d.items():
                np.testing.assert_array_equal(state[2][s][k], np.asarray(a), err_msg=k)
        assert rank["trainer_pm"]["local_shapes"]["layer_0/ffn/fc1/w"][1] * 2 == \
            cases.PIPE_LM["d_inner"]


def test_composed_guards_match_jax():
    """What stays refused: ``pipe`` beside ``seq`` and MoE FFNs in the
    pipelined path, with the JAX package's messages. The meshes and specs
    once refused in ``DataParallel`` — a ``tp`` axis, ``model`` beside
    ``expert``, ``pipe`` beside ``seq`` or ``expert``, batch specs over
    other axes and parameter specs over ``data`` (FSDP-like) — are taken,
    as the JAX package's GSPMD takes them (they step on their ranks in
    ``test_torch_any_mesh.py``), and so are the composed meshes."""
    batches, params, _, _ = _inputs()
    batch = _rows(batches[0], 4)
    seq = make_mesh(data=1, seq=2, devices=[0, 1])
    pipe = make_mesh(pipe=2, devices=[0, 1])
    tb = [torch.from_numpy(b) for b in batch]
    for kw, match in ((dict(ring_mesh="seq"), "sequence parallelism .ring_mesh/ulysses_mesh. "
                                              "does not compose with the pipelined path"),
                      (dict(moe_experts=4), "pipe_mesh: MoE FFNs unsupported")):
        tkw = {k: (seq if v == "seq" else v) for k, v in kw.items()}
        spec = tmodels.get_model("transformer_lm", device="cpu", pipe_mesh=pipe,
                                 **dict(cases.PIPE_LM, **tkw))
        # the MoE LM's own init (the ring's would run the ring: no group here)
        v = (spec.model.init(0, *tb, device="cpu") if "moe_experts" in kw
             else Variables(cases.tensors(params), {}))
        with pytest.raises(Exception, match=match):
            spec.model.apply(v, *tb)
        jkw = {k: (jmake_mesh(seq=2, data=4) if v == "seq" else v) for k, v in kw.items()}
        jspec = jmodels.get_model("transformer_lm", pipe_mesh=jmake_mesh(
            pipe=2, devices=jax.devices()[:2]), **dict(cases.PIPE_LM, **jkw))
        jv = JVariables({k: jnp.asarray(t.numpy()) for k, t in v.params.items()}, {})
        with pytest.raises(Exception, match=match):
            jspec.model.apply(jv, *batch)
    mlp, _ = cases.port_model("mlp")
    for axes in (dict(data=1, tp=2), dict(data=1, model=2, expert=2), dict(data=1, pipe=2, seq=2),
                 dict(data=1, pipe=2, expert=2), dict(data=1, pipe=2, model=2, seq=2)):
        n = int(np.prod(list(axes.values())))
        dp = DataParallel(mlp, topt.SGD(0.1), device="cpu", mesh=make_mesh(
            **axes, devices=list(range(n))))
        assert dp.num_devices == n and dp._token_axes == ("data",)
    # a batch split over an axis the layers consume: gathered whole over it
    dp = DataParallel(mlp, topt.SGD(0.1), device="cpu", batch_specs=(P("model"),),
                      mesh=make_mesh(data=1, model=2, devices=[0, 1]))
    assert dp._token_axes == () and dp.leading_multiple(np.zeros((4, 3))) == 2
    fsdp = tbuild(lambda x: tlayers.fc(x, 4, param_attr=ParamAttr(sharding=("data", None))),
                  name="fsdp")
    fv = fsdp.init(0, torch.zeros(2, 4), device="cpu")
    specs = sharding.param_shardings(make_mesh(data=2, devices=[0, 1]), fsdp.param_info, fv.params)
    assert sharding.split_blocks(specs) == ({}, {"fc/w": [(0, "data")]})
    for axes, zero in ((PM, False), (SM, False), (dict(data=2, pipe=2, model=2), False),
                       (E2, True), (D2E2, True), (dict(data=1, seq=2, expert=2), True)):
        dp = DataParallel(mlp, topt.SGD(0.1), device="cpu", zero_shard_optimizer=zero,
                          mesh=make_mesh(**axes, devices=list(range(
                              int(np.prod(list(axes.values())))))))
        assert dp.num_devices == int(np.prod(list(axes.values())))


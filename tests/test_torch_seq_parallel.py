"""The port's sequence parallelism against the JAX package's, on the CPU:
``ppermute`` and ``all_to_all`` on two gloo ranks against ``jax.lax``'s
under ``shard_map`` (values, zeros where no pair sends, gradients; the
point-to-point route, with a spy showing ``dist.all_gather`` is never
called), ``ring_attention_sharded`` (flash and composed routes, causal or
not, GQA, ``window``, ``kv_len`` and all three together) and
``ulysses_attention_sharded`` (``kv_len``, the pad to 128, the refusal of
indivisible heads) against the JAX package's (the counterparts of
``tests/test_parallel_extensions.py:168-260,408-452,523-751,842``), the LM
with ``ring_mesh``/``ulysses_mesh`` (sinusoid and rope, window, GQA,
ragged ``seq_lens``) in both of its modes — global arrays on every rank,
and a rank's block under ``DataParallel`` with ``P("data", "seq")`` —
against the JAX plain LM and the JAX sequence-parallel LM, ``DataParallel``
steps on ``seq=2`` (ring, Ulysses) and ``data=2 x seq=2`` (ring, ZeRO-1)
against the JAX package's ``DataParallel``, ``eval_step`` on a sequence
split, and ``Trainer(parallel=True)`` on ``seq=2``.

The port's ranks run one spawn of two gloo ranks and one of four (the rank
bodies are in ``torch_parallel_cases.py``). The JAX side runs on its
8-device CPU mesh (``seq=4, data=2`` as its tests use it) with
``use_flash=True``; both compute the global result.

Tolerances are the JAX tests' own: forward rtol 2e-4, atol 2e-5;
gradients rtol 2e-4, atol 2e-4; LM losses rtol 1e-4; parameters after
three Adam steps atol 1e-4 (``test_torch_data_parallel.py``'s), the
attention k biases (zero gradient in exact arithmetic) at the rates'
sum.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import torch_parallel_cases as cases
from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.ops.ring_attention import ring_attention_sharded as jring
from paddle_tpu.ops.ulysses import ulysses_attention_sharded as julysses
from paddle_tpu.parallel import DataParallel as JDataParallel
from paddle_tpu.parallel import collective as jcoll
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.parallel import launch

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
B, H, T, D = 2, 4, 32, 8


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# -- inputs -----------------------------------------------------------------
def _exchange_inputs():
    rng = np.random.RandomState(5)
    xs = [_rand(rng, 2, 4, 6) for _ in range(2)]
    shapes = {"ring": (2, 4, 6), "one_pair": (2, 4, 6), "a2a_0_1": (1, 8, 6),
              "a2a_1_0": (4, 2, 6), "a2a_2_2": (2, 4, 6), "a2a_untiled": (4, 6, 2)}
    ws = {k: [_rand(rng, *s) for _ in range(2)] for k, s in shapes.items()}
    return xs, ws


def _attention_cases():
    """name -> (kind, [kwargs of each port route], kwargs of the JAX call,
    q, k, v, w, kv_len): the global inputs. Where ``kv_len`` masks keys,
    ``w`` is zero on the rows at positions >= kv_len[b], whose output is
    defined only up to the loss's mask (the JAX test's convention)."""
    rng = np.random.RandomState(7)
    out = {}

    def add(name, kind, routes, h_kv=H, t=T, kv_len=None, h=H, **kw):
        q = _rand(rng, B, h, t, D)
        k, v = _rand(rng, B, h_kv, t, D), _rand(rng, B, h_kv, t, D)
        w = _rand(rng, B, h, t, D)
        if kv_len is not None:
            w = w * (np.arange(t)[None, :] < kv_len[:, None])[:, None, :, None]
        out[name] = (kind, [dict(kw, use_flash=f) for f in routes], dict(kw, use_flash=True),
                     q, k, v, w, kv_len)

    lens = np.array([21, 9], np.int32)
    both = (True, False)
    add("ring_full", "ring", both, causal=False)
    add("ring_causal", "ring", both, causal=True)
    add("ring_window", "ring", (True,), causal=True, window=5)
    add("ring_gqa_kv_len_window", "ring", both, h_kv=2, causal=True, window=7, kv_len=lens)
    add("ulysses_causal", "ulysses", both, causal=True)
    add("ulysses_kv_len", "ulysses", (True,), causal=True, kv_len=lens)
    add("ulysses_pad_to_128", "ulysses", (True,), t=320, causal=True,
        kv_len=np.array([300, 77], np.int32))
    add("ulysses_indivisible_heads", "ulysses", (False,), h=3, h_kv=3, causal=False)
    return out


def _lm_kw(**kw):
    return dict(cases.SP_LM, **kw)


# name -> (LM kwargs, sequence-parallel mode, ragged, held against the JAX
# sequence-parallel LM too (every case is held against the JAX plain LM))
LM_CASES = {
    "ring_rope_window_gqa": (_lm_kw(pos_encoding="rope", attention_window=6, num_kv_heads=2),
                             "ring", False, True),
    "ring_ragged_window": (_lm_kw(attention_window=9), "ring", True, False),
    "ulysses_rope_ragged": (_lm_kw(pos_encoding="rope"), "ulysses", True, True),
}


def _lm_inputs(name):
    kw, mode, ragged, _ = LM_CASES[name]
    rng = np.random.RandomState(11)
    spec = tmodels.get_model("transformer_lm", device="cpu", **kw)
    batch = tuple(b.numpy() for b in spec.synth_batch(4, rng))
    if ragged:
        batch += (np.array([32, 7, 19, 30], np.int32),)
    import torch

    v = spec.model.init(0, *(torch.from_numpy(b) for b in batch), device="cpu")
    return batch, {k: t.numpy() for k, t in v.params.items()}


TWO_RANK_DP = ("ring", "ulysses")
DATA2_ATTENTION = ("ring_causal", "ring_gqa_kv_len_window", "ulysses_kv_len")


def _dp_runs():
    """The DataParallel runs: the sinusoid LM on one batch and one set of
    weights, so one JAX run is every run's reference."""
    spec = tmodels.get_model("transformer_lm", device="cpu", **cases.SP_LM)
    import torch

    batch = tuple(b.numpy() for b in spec.synth_batch(4, np.random.RandomState(13)))
    params = {k: t.numpy() for k, t in spec.model.init(
        0, *(torch.from_numpy(b) for b in batch), device="cpu").params.items()}
    seq, seq_data = dict(data=1, seq=2), dict(data=2, seq=2)
    spec2 = [("data", "seq"), ("data", "seq")]
    ring = dict(_lm_kw(), seq_mode="ring", flash=True)
    return {
        "ring": (seq, ring, spec2, False, batch, params),
        "ulysses": (seq, dict(_lm_kw(), seq_mode="ulysses", flash=True), spec2, False, batch,
                    params),
        "ring_data2": (seq_data, ring, spec2, False, batch, params),
        "ring_data2_zero1": (seq_data, ring, spec2, True, batch, params),
    }


@pytest.fixture(scope="module")
def inputs():
    lm = {name: _lm_inputs(name) for name in LM_CASES}
    dp = _dp_runs()
    batch, params = dp["ring"][4:]
    more = tmodels.get_model("transformer_lm", device="cpu", **cases.SP_LM).synth_batch(
        4, np.random.RandomState(14))
    trainer = ([batch, tuple(b.numpy() for b in more)], params)
    return dict(exchanges=_exchange_inputs(), attention=_attention_cases(), lm=lm, dp=dp,
                trainer=trainer)


@pytest.fixture(scope="module")
def ranks(inputs):
    lm_cases = {name: (dict(LM_CASES[name][0], seq_mode=LM_CASES[name][1], flash=True),
                       *inputs["lm"][name]) for name in LM_CASES}
    two = {
        "trainer": ("sp_trainer", inputs["trainer"]),
        "exchanges": ("sp_exchanges", inputs["exchanges"]),
        "attention": ("sp_attention", (dict(data=1, seq=2), inputs["attention"])),
        "lm": ("sp_lm", (dict(data=1, seq=2), lm_cases)),
        "dp": ("sp_dp_steps", ({k: v for k, v in inputs["dp"].items() if k in TWO_RANK_DP},)),
    }
    four = {
        "attention_data2": ("sp_attention", (dict(data=2, seq=2), {
            k: inputs["attention"][k] for k in DATA2_ATTENTION})),
        "dp": ("sp_dp_steps", ({k: v for k, v in inputs["dp"].items()
                                if k not in TWO_RANK_DP},)),
    }
    out = launch.spawn(cases.calls, 2, args=(two,), device="cpu")
    out4 = launch.spawn(cases.calls, 4, args=(four,), device="cpu")
    return {"trainer": [r["trainer"] for r in out],
            "exchanges": [r["exchanges"] for r in out], "attention": [r for r in out],
            "attention_data2": [r for r in out4], "lm": [r["lm"] for r in out],
            "dp": [r["dp"] for r in out], "dp4": [r["dp"] for r in out4]}


@pytest.fixture
def jax_flash():
    saved = jconfig.flags().use_flash_attention
    jconfig.set_flags(use_flash_attention=True)
    yield
    jconfig.set_flags(use_flash_attention=saved)


# -- the exchanges ------------------------------------------------------------
def _jax_exchange(name, xs, ws):
    mesh = jmake_mesh(data=2, devices=jax.devices()[:2])
    fns = {
        "ring": lambda x: jcoll.ppermute(x, "data", [(0, 1), (1, 0)]),
        "one_pair": lambda x: jcoll.ppermute(x, "data", [(1, 0)]),
        "a2a_0_1": lambda x: jax.lax.all_to_all(x, "data", 0, 1, tiled=True),
        "a2a_1_0": lambda x: jax.lax.all_to_all(x, "data", 1, 0, tiled=True),
        "a2a_2_2": lambda x: jax.lax.all_to_all(x, "data", 2, 2, tiled=True),
    }
    g = jax.shard_map(fns[name], mesh=mesh, in_specs=JP("data"), out_specs=JP("data"))
    X = jnp.asarray(np.concatenate(xs))
    W = jnp.asarray(np.concatenate(ws[name]))
    vals = np.split(np.asarray(g(X)), 2)
    grads = np.split(np.asarray(jax.grad(lambda X: jnp.sum(W * g(X)))(X)), 2)
    return vals, grads


@pytest.mark.parametrize("name", ["ring", "one_pair", "a2a_0_1", "a2a_1_0", "a2a_2_2"])
def test_exchange_matches_jax_lax(ranks, inputs, name):
    xs, ws = inputs["exchanges"]
    vals, grads = _jax_exchange(name, xs, ws)
    for r in range(2):
        value, grad = ranks["exchanges"][r][name]
        np.testing.assert_allclose(value, vals[r], rtol=1e-6, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(grad, grads[r], rtol=1e-6, atol=1e-6, err_msg=name)
    if name == "one_pair":  # rank 1 is sent nothing: zeros, and no gradient flows back
        assert not ranks["exchanges"][1][name][0].any()
        assert not ranks["exchanges"][0][name][1].any()


def test_untiled_all_to_all_matches_jax(ranks, inputs):
    """``tiled=False``: the split axis (of the axis's size) goes, the pieces
    stack on ``concat_axis`` — ``jax.lax.all_to_all``'s shape rule and
    values. JAX cannot differentiate its untiled form with split_axis !=
    concat_axis (its transpose returns the wrong shape), so the gradient is
    held against the same exchange written tiled."""
    xs, ws = inputs["exchanges"]
    mesh = jmake_mesh(data=2, devices=jax.devices()[:2])

    def shard(f):
        return jax.shard_map(f, mesh=mesh, in_specs=JP("data"), out_specs=JP("data"))

    g = shard(lambda x: jax.lax.all_to_all(x, "data", 0, 2, tiled=False))
    g_tiled = shard(lambda x: jnp.moveaxis(jax.lax.all_to_all(x, "data", 0, 0, tiled=True), 0, 2))
    X = jnp.asarray(np.concatenate(xs))
    W = jnp.asarray(np.concatenate(ws["a2a_untiled"]))
    np.testing.assert_array_equal(np.asarray(g(X)), np.asarray(g_tiled(X)))
    vals = np.split(np.asarray(g(X)), 2)
    grads = np.split(np.asarray(jax.grad(lambda X: jnp.sum(W * g_tiled(X)))(X)), 2)
    for r in range(2):
        value, grad = ranks["exchanges"][r]["a2a_untiled"]
        assert value.shape == vals[r].shape == (4, 6, 2)
        np.testing.assert_allclose(value, vals[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grad, grads[r], rtol=1e-6, atol=1e-6)


def test_exchanges_go_point_to_point(ranks):
    """On CPU tensors under gloo the exchanges take gloo's point-to-point
    and all-to-all: ``dist.all_gather`` is never called."""
    for r in range(2):
        got = ranks["exchanges"][r]
        assert got["all_gather_calls"] == 0
        assert set(got["routes"]) == {"ppermute", "all_to_all"}
        assert all(set(by) == {"gloo"} for by in got["routes"].values())


# -- ring and Ulysses attention ------------------------------------------------
def _jax_attention(case):
    """The JAX package's value and gradients (one compile)."""
    kind, _, kw, q, k, v, w, kv_len = case
    mesh = jmake_mesh(seq=4, data=2)
    fn = jring if kind == "ring" else julysses
    lens = None if kv_len is None else jnp.asarray(kv_len)

    def f(a, b, c):
        out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, mesh, kv_len=lens, **kw), a, b, c)
        return (out,) + vjp(jnp.asarray(w))

    return [np.asarray(t) for t in jax.jit(f)(q, k, v)]


ATTENTION = [n for n in _attention_cases() if n != "ulysses_indivisible_heads"]


@pytest.mark.parametrize("name", ATTENTION)
def test_sharded_attention_matches_jax(ranks, inputs, name, jax_flash):
    """Each route of the port (flash, composed) on two ranks (``seq=2``),
    and some cases on four (``data=2 x seq=2``: the batch shards too),
    against the JAX package's flash route on ``seq=4 x data=2``."""
    case = inputs["attention"][name]
    want = _jax_attention(case)
    kv_len = case[-1]
    valid = slice(None)
    if kv_len is not None:
        valid = (np.arange(want[0].shape[2])[None, :] < kv_len[:, None])[:, None, :, None]
    for key in ("attention", "attention_data2"):
        for rank in ranks[key]:
            for i, got in enumerate(rank[key].get(name, ())):
                assert not isinstance(got, str), got
                what = f"{key} {name} route {i}"
                np.testing.assert_allclose(np.where(valid, got[0], 0), np.where(valid, want[0], 0),
                                           err_msg=f"{what} out", **FWD)
                for g, wg, n in zip(got[1:], want[1:], "qkv"):
                    np.testing.assert_allclose(g, wg, err_msg=f"{what} d{n}", **GRAD)


def test_ulysses_refuses_indivisible_heads(ranks):
    """3 heads over a seq axis of 2: the JAX package's message."""
    for r in range(2):
        (got,) = ranks["attention"][r]["attention"]["ulysses_indivisible_heads"]
        assert isinstance(got, str) and "num_heads 3 not divisible by seq size 2" in got
    mesh = jmake_mesh(seq=4, data=2)
    q = jnp.zeros((2, 3, 32, 8), jnp.float32)
    with pytest.raises(Exception, match="num_heads 3 not divisible by seq size 4"):
        julysses(q, q, q, mesh, causal=False, use_flash=False)


# -- the LM ---------------------------------------------------------------------
def _jax_lm(name, batch, params, mesh_kw):
    kw = LM_CASES[name][0]
    spec = jmodels.get_model("transformer_lm", **mesh_kw, **kw)

    def loss(p):
        (l, _, _), _ = spec.model.apply(JVariables(p, {}), *batch, is_train=True)
        return l

    value, grads = jax.jit(jax.value_and_grad(loss))({k: jnp.asarray(a) for k, a in
                                                      params.items()})
    return float(value), {k: np.asarray(g) for k, g in grads.items()}


@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_matches_jax_plain_and_sequence_parallel(ranks, inputs, name, jax_flash):
    """Loss and every parameter's gradient, global-arrays mode and a
    rank's block under DataParallel, against the JAX plain LM and (where
    marked) the JAX LM on its sequence-parallel mesh."""
    batch, params = inputs["lm"][name]
    _, mode, _, with_sp = LM_CASES[name]
    wants = [_jax_lm(name, batch, params, {})]
    if with_sp:
        wants.append(_jax_lm(name, batch, params, {f"{mode}_mesh": jmake_mesh(seq=4, data=2)}))
    for want_loss, want in wants:
        for r in range(2):
            for how in ("global", "block"):
                loss, grads = ranks["lm"][r][name][how]
                np.testing.assert_allclose(loss, want_loss, rtol=1e-4, err_msg=f"{name} {how}")
                assert set(grads) == set(want)
                for k, g in grads.items():
                    np.testing.assert_allclose(g, want[k], err_msg=f"{name} {how} {k}", **GRAD)
    # DataParallel gathers the logits of the blocks to the global batch
    assert ranks["lm"][0][name]["logits_shape"] == (4, cases.SP_LM["seq_len"],
                                                    cases.SP_LM["vocab"])


# -- DataParallel ---------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_dp(inputs):
    """The JAX DataParallel (ring, flash) on ``seq=2 x data=2``: three Adam
    steps from the runs' weights on their batch."""
    axes, kw, specs, zero, batch, params = inputs["dp"]["ring"]
    kw = {k: v for k, v in kw.items() if k not in ("seq_mode", "flash")}
    mesh = jmake_mesh(seq=2, data=2, devices=jax.devices()[:4])
    saved = jconfig.flags().use_flash_attention
    jconfig.set_flags(use_flash_attention=True)
    try:
        spec = jmodels.get_model("transformer_lm", ring_mesh=mesh, **kw)
        dp = JDataParallel(spec.model, spec.optimizer(), mesh=mesh, donate=False,
                           batch_specs=[JP(*s) for s in specs])
        v, o = dp.init(jax.random.PRNGKey(0), *batch, variables=JVariables(
            {k: jnp.asarray(a) for k, a in params.items()}, {}))
        losses = []
        for _ in range(cases.STEPS):
            out = dp.step(v, o, *dp.put_batch(*batch))
            v, o = out.variables, out.opt_state
            losses.append(float(out.loss))
    finally:
        jconfig.set_flags(use_flash_attention=saved)
    return losses, {k: np.asarray(a) for k, a in v.params.items()}


def _lr_sum():
    spec = tmodels.get_model("transformer_lm", device="cpu", **cases.SP_LM)
    opt = spec.optimizer()
    return sum(opt.scheduler(t) for t in range(cases.STEPS))


def _held(got, losses, params, lr):
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for k, a in params.items():
        atol = lr if k.endswith("self_attn/k/b") else 1e-4
        np.testing.assert_allclose(got["state"][0][k], a, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ["ring", "ulysses", "ring_data2"])
def test_dp_seq2_matches_jax_dp(ranks, jax_dp, name):
    """Three Adam steps with ``P("data", "seq")`` on ``seq=2`` (two ranks)
    or ``data=2 x seq=2`` (four): against the JAX DataParallel on
    ``seq=2 x data=2``; the replicas stay bit-equal, and the exchanges went
    point to point."""
    losses, params = jax_dp
    got = ranks["dp"] if name in TWO_RANK_DP else ranks["dp4"]
    for rank in got:
        _held(rank[name], losses, params, _lr_sum())
    assert len({rank[name]["digest"] for rank in got}) == 1
    route = "all_to_all" if name == "ulysses" else "ppermute"
    assert set(got[0][name]["routes"][route]) == {"gloo"}


@pytest.mark.parametrize("name", ["ring", "ring_data2"])
def test_dp_seq2_eval_step_gathers_whole_rows(ranks, inputs, name):
    """``eval_step`` on a sequence split: the logits of every block
    gathered to the global batch (positions, then rows), and the mean
    loss, equal to the single-device eval at the same parameters."""
    _, kw, _, _, batch, _ = inputs["dp"][name]
    spec = tmodels.get_model("transformer_lm", device="cpu", **cases.SP_LM)
    import torch

    got = (ranks["dp"] if name in TWO_RANK_DP else ranks["dp4"])[0][name]
    from paddle_tpu_torch.framework import Variables

    params = {k: torch.from_numpy(a) for k, a in got["state"][0].items()}
    (loss, _, logits), _ = spec.model.apply(Variables(params, {}),
                                            *(torch.from_numpy(b) for b in batch), is_train=False)
    np.testing.assert_allclose(got["eval_logits"], logits.numpy(), **FWD)
    np.testing.assert_allclose(got["eval_loss"], float(loss), rtol=1e-5)


def test_dp_seq2_zero1_equals_plain_with_halved_slots(ranks):
    """ZeRO-1 on ``data=2 x seq=2``: the slots shard over ``data`` (each
    rank keeps half), the step equals the plain one bit for bit."""
    for rank in ranks["dp4"]:
        plain, zero = rank["ring_data2"], rank["ring_data2_zero1"]
        assert zero["losses"] == plain["losses"]
        assert zero["digest"] == plain["digest"]
        assert zero["slot_bytes"] <= 0.51 * plain["slot_bytes"]
        for s, d in plain["state"][2].items():
            for k, a in d.items():
                np.testing.assert_array_equal(zero["state"][2][s][k], a)


def test_trainer_on_seq2_equals_dataparallel_and_evaluates_whole_rows(ranks):
    """``Trainer(parallel=True)`` with ``P("data", "seq")`` batches takes the
    DataParallel steps (losses bit-equal), and its exact ``evaluate``
    reads whole rows (the segments gathered), equal to the gathered
    ``eval_step`` logits' accuracy."""
    for rank in ranks["trainer"]:
        assert rank["losses"] == rank["dp_losses"] and len(rank["losses"]) == 2
        assert rank["metric"] == pytest.approx(rank["want"], abs=1e-12)

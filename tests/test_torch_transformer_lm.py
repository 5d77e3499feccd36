"""The port's transformer LM (``paddle_tpu_torch.models.transformer_lm``)
against the JAX package's, on identical weights: the JAX ``init``'s
parameters are carried into the port with ``params_from_jax``.

Small sizes (2 layers, d_model 32, vocab 64) on the CPU, f32. ``lm_forward``
logits agree within atol=1e-4; ``generate()`` greedy tokens are
token-exact, with ``use_flash_attention`` on and off. Each greedy step's
top-1/top-2 logit margin is asserted to be well above the logits' agreement,
so a near tie cannot flip a token between the packages.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu.models import transformer_lm as jlm
from paddle_tpu_torch import convert
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.models import transformer_lm as tlm

SMALL = dict(seq_len=16, vocab=64, d_model=32, d_inner=64, num_heads=4, n_layers=2)
VARIANTS = {
    "base": {},
    "gqa_rope": dict(num_kv_heads=2, pos_encoding="rope"),
    "window_swiglu": dict(attention_window=5, ffn_activation="swiglu"),
}
LOGITS_ATOL = 1e-4
# a greedy step is compared only where top-1 beats top-2 by this much: far
# above the two packages' f32 logit agreement (~1e-6)
MARGIN = 1e-3


@pytest.fixture
def set_both_flags():
    names = ("use_flash_attention", "use_bf16_compute")
    saved_j = {f: getattr(jconfig.flags(), f) for f in names}
    saved_t = {f: getattr(tconfig.flags(), f) for f in names}

    def set_(**kw):
        jconfig.set_flags(**kw)
        tconfig.set_flags(**kw)

    yield set_
    jconfig.set_flags(**saved_j)
    tconfig.set_flags(**saved_t)


def _models(variant, seed=0, **extra):
    kw = dict(SMALL, **VARIANTS[variant], **extra)
    jspec = jmodels.get_model("transformer_lm", **kw)
    tspec = tmodels.get_model("transformer_lm", device="cpu", **kw)
    rng = np.random.RandomState(seed)
    batch = jspec.synth_batch(2, rng)
    jvars = jspec.model.init(jax.random.PRNGKey(seed), *batch)
    tparams = convert.params_from_jax({n: np.asarray(a) for n, a in jvars.params.items()}, "cpu")
    return jspec, tspec, jvars, tparams, batch


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_names_and_shapes_match_jax(variant):
    jspec, tspec, jvars, _, batch = _models(variant)
    tvars = tspec.model.init(0, *(torch.from_numpy(b) for b in batch), device="cpu")
    assert set(tvars.params) == set(jvars.params)
    for name, t in tvars.params.items():
        assert tuple(t.shape) == jvars.params[name].shape, name
        assert t.dtype == torch.float32 and t.device.type == "cpu", name
    assert tvars.state == {}


def test_init_is_seeded():
    _, tspec, _, _, batch = _models("base")
    ids = [torch.from_numpy(b) for b in batch]
    a = tspec.model.init(3, *ids, device="cpu").params
    b = tspec.model.init(3, *ids, device="cpu").params
    c = tspec.model.init(4, *ids, device="cpu").params
    name = "layer_0/self_attn/q/w"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lm_forward_matches_jax(set_both_flags, variant, flash):
    set_both_flags(use_flash_attention=flash)
    jspec, tspec, jvars, tparams, (ids, labels) = _models(variant)
    (jloss, jn, jlogits), _ = jspec.model.apply(jvars, ids, labels, is_train=False)
    (tloss, tn, tlogits), state = tspec.model.apply(tparams, torch.from_numpy(ids), torch.from_numpy(labels))
    assert state == {} and tn == jn
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_lm_forward_seq_lens_matches_jax(set_both_flags, flash):
    set_both_flags(use_flash_attention=flash)
    jspec, tspec, jvars, tparams, (ids, labels) = _models("base")
    lens = np.array([16, 9], np.int32)
    (jloss, jn, jlogits), _ = jspec.model.apply(jvars, ids, labels, jnp.asarray(lens), is_train=False)
    (tloss, tn, tlogits), _ = tspec.model.apply(
        tparams, torch.from_numpy(ids), torch.from_numpy(labels), torch.from_numpy(lens))
    assert float(tn) == float(jn)
    # positions past seq_len see no real key beyond it: compare the live ones
    for b, n in enumerate(lens):
        np.testing.assert_allclose(tlogits[b, :n].numpy(), np.asarray(jlogits)[b, :n],
                                   rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_lm_forward_bf16_compute_close_to_jax(set_both_flags):
    """bf16 tensor-core operands in every fc and in the attention: both
    packages round at the same sites; 5e-2 absolute on logits of ~unit
    scale covers bf16's 2^-8 relative rounding through two layers."""
    set_both_flags(use_flash_attention=True, use_bf16_compute=True)
    jspec, tspec, jvars, tparams, (ids, labels) = _models("base")
    (_, _, jlogits), _ = jspec.model.apply(jvars, ids, labels, is_train=False)
    (_, _, tlogits), _ = tspec.model.apply(tparams, torch.from_numpy(ids), torch.from_numpy(labels))
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=5e-2)


def _assert_greedy_margin(tparams, cfg, prompt, tokens):
    """Every greedy step's top-1/top-2 logit gap exceeds MARGIN, so the
    token-exact comparison cannot hinge on a near tie."""
    n_new = tokens.shape[1]
    with torch.no_grad():
        dec = tlm.CachedDecoder(tparams, cfg, prompt.shape[0], prompt.shape[1] + n_new)
        logits = [dec.prefill(prompt)]
        for s in range(n_new - 1):
            logits.append(dec.step(tokens[:, s], prompt.shape[1] + s))
    for s, lg in enumerate(logits):
        top2 = torch.topk(lg, 2, dim=-1).values
        assert bool(((top2[:, 0] - top2[:, 1]) > MARGIN).all()), f"near tie at step {s}"
        assert torch.equal(torch.argmax(lg, -1).to(torch.int32), tokens[:, s])


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_greedy_token_exact_vs_jax(set_both_flags, variant, flash):
    set_both_flags(use_flash_attention=flash)
    jspec, tspec, jvars, tparams, _ = _models(variant)
    cfg = tspec.extra["cfg"]
    prompt = np.random.RandomState(12).randint(1, 64, size=(2, 16)).astype(np.int32)
    jtok = np.asarray(jlm.generate(jvars, jnp.asarray(prompt), 6, jspec.extra["cfg"]))
    ttok = tlm.generate(tparams, torch.from_numpy(prompt), 6, cfg, device="cpu")
    assert ttok.dtype == torch.int32 and tuple(ttok.shape) == (2, 6)
    _assert_greedy_margin(tparams, cfg, torch.from_numpy(prompt), ttok)
    np.testing.assert_array_equal(ttok.numpy(), jtok)


def test_generate_prefill_routes_flash_once_per_layer(set_both_flags, monkeypatch):
    """generate()'s prefill calls sdpa once per layer and each call routes
    into the flash wrapper; decode steps compose attention from einsums."""
    import importlib

    tfa = importlib.import_module("paddle_tpu_torch.ops.cuda.flash_attention")
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    set_both_flags(use_flash_attention=True)
    _, tspec, _, tparams, _ = _models("base")
    prompt = torch.from_numpy(np.random.RandomState(12).randint(1, 64, size=(2, 16)).astype(np.int32))
    tlm.generate(tparams, prompt, 4, tspec.extra["cfg"], device="cpu")
    assert len(calls) == SMALL["n_layers"]


def test_generate_bf16_cache_keeps_confident_tokens():
    _, tspec, _, tparams, _ = _models("base")
    cfg = tspec.extra["cfg"]
    prompt = torch.from_numpy(np.random.RandomState(13).randint(1, 64, size=(2, 16)).astype(np.int32))
    f32 = tlm.generate(tparams, prompt, 4, cfg, device="cpu")
    bf16 = tlm.generate(tparams, prompt, 4, cfg, cache_dtype=torch.bfloat16, device="cpu")
    assert bf16.shape == f32.shape
    assert torch.equal(bf16[:, 0], f32[:, 0])  # the prefill logits never read the cache


def test_generate_sampling_is_seeded_and_in_range():
    _, tspec, _, tparams, _ = _models("base")
    cfg = tspec.extra["cfg"]
    prompt = torch.from_numpy(np.random.RandomState(14).randint(1, 64, size=(2, 16)).astype(np.int32))

    def sample(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tlm.generate(tparams, prompt, 5, cfg, temperature=0.8, generator=g, device="cpu", **kw)

    a, b = sample(1, top_p=0.9), sample(1, top_p=0.9)
    assert torch.equal(a, b) and a.shape == (2, 5)
    assert bool(((a >= 0) & (a < 64)).all())
    # top_k=1 keeps only the argmax: sampling degenerates to greedy
    greedy = tlm.generate(tparams, prompt, 5, cfg, device="cpu")
    assert torch.equal(sample(2, top_k=1), greedy)
    with pytest.raises(Exception, match="Generator"):
        tlm.generate(tparams, prompt, 2, cfg, temperature=0.5, device="cpu")


def test_cuda_default_raises_without_cuda():
    """Entry points default to CUDA and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodels.get_model("transformer_lm", **SMALL)
    _, tspec, _, tparams, batch = _models("base")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tspec.model.init(0, *(torch.from_numpy(b) for b in batch))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.generate(tparams, torch.ones(1, 8, dtype=torch.int32), 2, tspec.extra["cfg"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_jax({"w": np.zeros(2, np.float32)})


@pytest.mark.parametrize("knob,match", [
    (dict(residual_dropout=0.1), "pipe_mesh: dropout must be 0"),
    (dict(ring_mesh="mesh"), "pipe_mesh: sequence parallelism"),
    (dict(ulysses_mesh="mesh"), "pipe_mesh: sequence parallelism"),
    (dict(moe_experts=4), "pipe_mesh: MoE FFNs unsupported"),
    (dict(seq_lens=True), "pipe_mesh: ragged seq_lens unsupported")],
    ids=["knob0", "knob1", "knob2", "knob3", "knob4"])
def test_unported_knobs_raise(knob, match):
    """Pipeline parallelism trains (``tests/test_torch_pipeline.py``); beside
    dropout, the sequence-parallel cores, MoE FFNs or ragged ``seq_lens`` it
    raises the JAX package's messages when the model runs (a one-stage
    ``pipe`` mesh here)."""
    from paddle_tpu_torch.parallel import make_mesh

    knob = {k: make_mesh(data=1, seq=1) if v == "mesh" else v for k, v in knob.items()}
    ragged = knob.pop("seq_lens", False)
    tspec = tmodels.get_model("transformer_lm", device="cpu", **SMALL, **knob,
                              pipe_mesh=make_mesh(pipe=1))
    ids, labels = tspec.synth_batch(2, np.random.RandomState(0))
    v = tspec.model.init(0, ids, labels, device="cpu")
    extra = (torch.full((2,), 4, dtype=torch.int32),) if ragged else ()
    with pytest.raises(Exception, match=match):
        tspec.model.apply(v, ids, labels, *extra, rng=torch.Generator().manual_seed(0),
                          is_train=True)


def test_params_round_trip_through_numpy():
    _, _, jvars, tparams, _ = _models("base")
    back = convert.params_to_numpy(tparams)
    assert set(back) == set(jvars.params)
    for name, arr in back.items():
        np.testing.assert_array_equal(arr, np.asarray(jvars.params[name]))
    bf = convert.params_from_jax({"w": np.asarray(jnp.ones((2, 3), jnp.bfloat16) * 1.5)}, "cpu")
    assert bf["w"].dtype == torch.bfloat16 and float(bf["w"][0, 0]) == 1.5
    assert convert.params_to_numpy(bf)["w"].dtype == np.float32


@pytest.mark.parametrize("dropout,flash", [(0.0, True), (0.1, True), (0.1, False)],
                         ids=["dropout0_flash", "dropout_flash_flag", "dropout_composed"])
def test_remat_matches_plain_exactly(set_both_flags, monkeypatch, dropout, flash):
    """cfg remat=True recomputes each layer in the backward pass with the
    same parameter names and the same dropout masks (the generator is
    replayed): the loss and every gradient equal the plain model's, bit for
    bit, with one generator seed. At dropout 0 with flash on, the recompute
    shows as a second flash call per layer."""
    import importlib

    from paddle_tpu_torch import backward as tbackward

    tfa = importlib.import_module("paddle_tpu_torch.ops.cuda.flash_attention")
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    set_both_flags(use_flash_attention=flash)
    drops = dict(attn_dropout=dropout, relu_dropout=dropout, residual_dropout=dropout)
    out, n_calls = {}, {}
    for remat in (False, True):
        tspec = tmodels.get_model("transformer_lm", device="cpu", remat=remat, **SMALL, **drops)
        ids, labels = tspec.synth_batch(2, np.random.RandomState(15))
        params = tspec.model.init(0, ids, labels, device="cpu").params
        calls.clear()
        out[remat] = tbackward.append_backward(
            tspec.model, ids, labels, rng=torch.Generator().manual_seed(4))(params)
        n_calls[remat] = len(calls)
    (l0, (g0, _, _)), (l1, (g1, _, _)) = out[False], out[True]
    assert torch.equal(l0, l1)
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name
    if dropout == 0.0:
        assert n_calls == {False: SMALL["n_layers"], True: 2 * SMALL["n_layers"]}
    else:
        assert n_calls == {False: 0, True: 0}
        # the masks matter: another seed gives another loss
        other = tbackward.append_backward(tspec.model, ids, labels,
                                          rng=torch.Generator().manual_seed(5))(params)[0]
        assert not torch.equal(other, l1)


def test_remat_matches_jax_at_dropout0(set_both_flags):
    """The remat model's gradients against the JAX package's remat model
    (dropout 0, f32): rel L2 1e-4 per parameter, floored at 1e-2 of the
    largest norm for the k biases' rounding noise."""
    from paddle_tpu import backward as jbackward

    from paddle_tpu_torch import backward as tbackward

    set_both_flags(use_flash_attention=True)
    jspec, tspec, jvars, tparams, (ids, labels) = _models("base", remat=True)
    jloss, (jgrads, _, _) = jbackward.append_backward(jspec.model, ids, labels)(jvars.params)
    tloss, (tgrads, _, _) = tbackward.append_backward(
        tspec.model, torch.from_numpy(ids), torch.from_numpy(labels))(tparams)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    norms = {n: np.linalg.norm(np.asarray(g)) for n, g in jgrads.items()}
    floor = 1e-2 * max(norms.values())
    for n, g in jgrads.items():
        rel = np.linalg.norm(tgrads[n].numpy() - np.asarray(g)) / max(norms[n], floor)
        assert rel <= 1e-4, (n, rel)

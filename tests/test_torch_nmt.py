"""The port's NMT Transformer (``paddle_tpu_torch.models.transformer``)
against the JAX package's, on identical weights (the JAX ``init``'s
parameters carried across with ``params_from_jax``), on the CPU in f32.

Small size: seq 16, vocab 64, d_model 32, 4 heads, 2 + 2 layers, every
dropout 0. With ``use_flash_attention`` on, both packages mask
structurally (padding as ``kv_len``, the decoder's causality as the
kernel's) and route attention through the flash path: the JAX package's
Pallas kernels in interpret mode, the port's plain versions of its CUDA
kernels. Tolerances: the loss at 1e-5 relative, every gradient at 1e-4
relative L2 (floored at 1e-2 of the largest gradient's norm: the k
projections' biases have zero gradient in exact arithmetic, a constant
added to all of a row's scores cancels in the softmax, so theirs is
rounding noise in both packages), logits at 1e-5 absolute.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import backward as jbackward
from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu.models import transformer as jtr
from paddle_tpu.ops import nn as jnn
from paddle_tpu_torch import backward as tbackward
from paddle_tpu_torch import convert, framework
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import nn as tnn

SMALL = dict(seq_len=16, src_vocab=64, trg_vocab=64, d_model=32, d_inner=64, num_heads=4,
             n_layers=2, max_len=32, attn_dropout=0.0, relu_dropout=0.0, residual_dropout=0.0)
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR, LOGITS_ATOL = 1e-5, 1e-4, 1e-2, 1e-5


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


def _models(seed=0, batch_size=3, **extra):
    kw = dict(SMALL, **extra)
    jspec = jmodels.get_model("transformer", **kw)
    tspec = tmodels.get_model("transformer", device="cpu", **kw)
    batch = jspec.synth_batch(batch_size, np.random.RandomState(seed))
    jvars = jspec.model.init(jax.random.PRNGKey(seed), *batch)
    tparams = convert.params_from_jax({n: np.asarray(a) for n, a in jvars.params.items()}, "cpu")
    return jspec, tspec, jvars, tparams, batch


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(b)) for b in batch)


def _assert_grads_close(tgrads, jgrads, tol=GRAD_RTOL):
    assert set(tgrads) == set(jgrads)
    norms = {n: float(np.linalg.norm(np.asarray(g))) for n, g in jgrads.items()}
    floor = GRAD_FLOOR * max(norms.values())
    for n, g in jgrads.items():
        rel = np.linalg.norm(tgrads[n].numpy() - np.asarray(g)) / max(norms[n], floor)
        assert rel <= tol, (n, rel)


def test_param_names_and_shapes_match_jax():
    jspec, tspec, jvars, _, batch = _models()
    tvars = tspec.model.init(0, *_t(batch), device="cpu")
    assert set(tvars.params) == set(jvars.params)
    for name, t in tvars.params.items():
        assert tuple(t.shape) == jvars.params[name].shape, name
    assert tvars.state == {}


def test_synth_batch_matches_jax_and_lands_on_device():
    jspec, tspec, *_ = _models()
    jb = jspec.synth_batch(4, np.random.RandomState(5))
    tb = tspec.synth_batch(4, np.random.RandomState(5))
    assert len(tb) == len(jb) == 6
    for a, b in zip(tb, jb):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tspec.extra["cfg"]["scan_layers"] is False and tspec.unit == "tokens/sec"


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_loss_and_every_gradient_match_jax(set_both_flags, flash):
    set_both_flags(use_flash_attention=flash)
    jspec, tspec, jvars, tparams, batch = _models(1)
    jloss, (jgrads, _, (_, jn, _)) = jbackward.append_backward(jspec.model, *batch)(jvars.params)
    tloss, (tgrads, _, (_, tn, _)) = tbackward.append_backward(tspec.model, *_t(batch))(tparams)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert float(tn) == float(jn)
    _assert_grads_close(tgrads, jgrads)


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_eval_logits_match_jax_at_non_pad_positions(set_both_flags, flash):
    """Pad queries differ between structural and additive masking on
    purpose; the loss never reads them, so only valid rows are compared."""
    set_both_flags(use_flash_attention=flash)
    jspec, tspec, jvars, tparams, batch = _models(2)
    (jloss, _, jlogits), _ = jspec.model.apply(jvars, *batch, is_train=False)
    (tloss, _, tlogits), _ = tspec.model.apply(tparams, *_t(batch))
    valid = ~np.asarray(batch[3])
    np.testing.assert_allclose(tlogits.numpy()[valid], np.asarray(jlogits)[valid], rtol=0,
                               atol=LOGITS_ATOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)


def test_structural_masking_matches_additive_in_the_port(set_both_flags):
    """Flash on (kv_len + causal) against flash off (additive masks) in the
    port alone: the loss and every gradient."""
    _, tspec, _, tparams, batch = _models(3)
    out = {}
    for flash in (False, True):
        set_both_flags(use_flash_attention=flash)
        out[flash] = tbackward.append_backward(tspec.model, *_t(batch))(tparams)
    np.testing.assert_allclose(float(out[True][0]), float(out[False][0]), rtol=LOSS_RTOL)
    _assert_grads_close(out[True][1][0], {n: g.numpy() for n, g in out[False][1][0].items()})


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_flash_routes_every_attention_of_eval_and_dropout0_training(set_both_flags, monkeypatch,
                                                                    flash):
    """Structural masking sends all 3 * n_layers attentions through the
    flash wrapper (non-causal with kv_len: encoder self and cross; causal:
    decoder self); additive masks never route."""
    import importlib

    tfa = importlib.import_module("paddle_tpu_torch.ops.cuda.flash_attention")
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a, **k: calls.append(k) or real(*a, **k))
    set_both_flags(use_flash_attention=flash)
    _, tspec, _, tparams, batch = _models(4)
    tspec.model.apply(tparams, *_t(batch))
    n = SMALL["n_layers"]
    assert len(calls) == (3 * n if flash else 0)
    if flash:
        assert sum(c["causal"] for c in calls) == n
        assert sum(c["kv_len"] is not None and not c["causal"] for c in calls) == 2 * n


def test_published_dropout_training_composes_attention(set_both_flags, monkeypatch):
    """The published dropouts (0.1): a training apply composes attention
    (no flash call, as the JAX package routes it) with dropout drawn from
    the apply's generator — seeded, so one seed gives one loss."""
    import importlib

    tfa = importlib.import_module("paddle_tpu_torch.ops.cuda.flash_attention")
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a, **k: calls.append(k) or real(*a, **k))
    set_both_flags(use_flash_attention=True)
    kw = dict(attn_dropout=0.1, relu_dropout=0.1, residual_dropout=0.1)
    _, tspec, _, tparams, batch = _models(5, **kw)

    def loss(seed):
        (l, _, _), _ = tspec.model.apply(tparams, *_t(batch), is_train=True,
                                         rng=torch.Generator().manual_seed(seed))
        return float(l)

    assert loss(0) == loss(0) != loss(1)
    assert calls == []
    (l_eval, _, _), _ = tspec.model.apply(tparams, *_t(batch))
    assert len(calls) == 3 * SMALL["n_layers"] and np.isfinite(float(l_eval))


def _decode_fns(cfg, jax_side):
    """Encoder and cached-decoder programs of one package, built over the
    full model's parameter names."""
    mod, pkg = (jtr, jpt) if jax_side else (ttr, framework)
    enc = pkg.build(lambda src, src_pad: mod.encode(src, src_pad, cfg))
    dec = pkg.build(lambda trg, trg_pad, enc_out, src_pad, caches, pos: mod.decode(
        trg, trg_pad, enc_out, src_pad, cfg, caches=caches, pos_offset=pos))
    full = pkg.build(lambda trg, trg_pad, enc_out, src_pad: mod.decode(
        trg, trg_pad, enc_out, src_pad, cfg))
    return enc, dec, full


def test_cached_decode_steps_match_jax_and_the_full_decode(set_both_flags):
    """``decode(caches=, pos_offset=)`` one target token at a time: each
    step's logits against the JAX package's step and against the full
    (teacher-forced) decode's logits at that position, where the position
    is not padding (the cached step attends every earlier token). A step's
    ids are [B, 1, 1]: the embedding lookup drops the trailing LoD-style
    1, as in both packages."""
    set_both_flags(use_flash_attention=False)
    jspec, tspec, jvars, tparams, batch = _models(6)
    src, src_pad, trg, trg_pad = batch[:4]
    cfg = tspec.extra["cfg"]
    jenc, jdec, _ = _decode_fns(jspec.extra["cfg"], True)
    tenc, tdec, tfull = _decode_fns(cfg, False)
    jenc_out, _ = jenc.apply(jvars, src, src_pad)
    tenc_out, _ = tenc.apply(tparams, *_t((src, src_pad)))
    np.testing.assert_allclose(tenc_out.numpy(), np.asarray(jenc_out), rtol=0, atol=1e-5)
    full, _ = tfull.apply(tparams, *_t((trg, trg_pad)), tenc_out, torch.from_numpy(src_pad))
    b, t = trg.shape
    dh = cfg["d_model"] // cfg["num_heads"]
    zeros = np.zeros((b, cfg["num_heads"], 0, dh), np.float32)
    jcaches = [{"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)} for _ in range(cfg["n_layers"])]
    tcaches = [{"k": torch.from_numpy(zeros), "v": torch.from_numpy(zeros)}
               for _ in range(cfg["n_layers"])]
    valid = ~np.asarray(trg_pad)
    for s in range(t):
        step = (trg[:, s:s + 1, None], trg_pad[:, s:s + 1])
        jl, _ = jdec.apply(jvars, *step, jenc_out, src_pad, jcaches, s)
        tl, _ = tdec.apply(tparams, *_t(step), tenc_out, torch.from_numpy(src_pad), tcaches, s)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGITS_ATOL)
        rows = valid[:, s]
        np.testing.assert_allclose(tl[rows, 0].numpy(), full[rows, s].numpy(), rtol=0,
                                   atol=LOGITS_ATOL)
    assert tuple(tcaches[0]["k"].shape) == (b, cfg["num_heads"], t, dh)


@pytest.mark.parametrize("eps", [0.0, 0.1, 0.3])
def test_label_smooth_and_one_hot_match_jax(eps):
    ids = np.random.RandomState(7).randint(0, 10, size=(3, 5)).astype(np.int32)
    j = jnn.label_smooth(jnn.one_hot(jnp.asarray(ids), 10), eps)
    t = tnn.label_smooth(tnn.one_hot(torch.from_numpy(ids), 10), eps)
    assert t.dtype == torch.float32 and tuple(t.shape) == (3, 5, 10)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-7, atol=1e-7)
    # a trailing 1 dim is squeezed, as in the reference
    np.testing.assert_array_equal(tnn.one_hot(torch.from_numpy(ids[..., None]), 10).numpy(),
                                  np.asarray(jnn.one_hot(jnp.asarray(ids[..., None]), 10)))


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for name in ("transformer", "stacked_dynamic_lstm", "machine_translation"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmodels.get_model(name)


def test_noam_adam_step_trains(set_both_flags):
    """The spec's optimizer (Adam + Noam) through ``minimize``: the loss of
    three steps on one batch matches the JAX package's jitted step."""
    set_both_flags(use_flash_attention=True)
    jspec, tspec, jvars, tparams, batch = _models(8, warmup_steps=4)
    jopt, topt = jspec.optimizer(), tspec.optimizer()
    jstep, tstep = jax.jit(jopt.minimize(jspec.model)), topt.minimize(tspec.model)
    js, ts = jopt.create_state(jvars.params), topt.create_state(tparams)
    tv = framework.Variables(tparams, {})
    jl, tl = [], []
    for _ in range(3):
        jo, to = jstep(jvars, js, *batch), tstep(tv, ts, *_t(batch))
        jvars, js, tv, ts = jo.variables, jo.opt_state, to.variables, to.opt_state
        jl.append(float(jo.loss))
        tl.append(float(to.loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]

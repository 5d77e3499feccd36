"""The tiny LM, prompts and references shared by the port's fleet-serving
tests (``tests/test_torch_serving_recovery.py``,
``tests/test_torch_host_tier.py``, ``tests/test_torch_serving_disagg.py``
and ``tests/test_torch_fleet_observability.py``).

The JAX tests' tiny LM (vocab 97, d_model 32, 2 layers); the port's init
(key 0) gives both packages' weights, carried to the JAX package with
``convert.params_to_numpy`` (the JAX init runs op by op and takes seconds
more). Two prompt sets, drawn from numpy seeds as in the JAX tests:
``mixed`` (three prompts of 4-11 tokens, 8-15 new tokens, seed 1, as in
``tests/test_serving_disagg.py``) and ``prefixed`` (five prompts sharing a
14-token system prefix, 6-11 new tokens, seed 11, as in
``tests/test_host_tier.py``). ``refs`` holds one JAX ``DecodeEngine``'s
tokens for each prompt (the JAX package's own tests hold those equal to
``generate()``); every reference step's top-1/top-2 logit gap in the port's
f32 ``CachedDecoder`` is asserted above ``MARGIN``, so equal tokens across
the packages cannot hinge on a near tie. Built once per process.
"""

import functools
import types

import numpy as np
import torch

VOCAB = 97
MARGIN = 1e-3
WAIT_S = 120  # any one result; the CPU runs take well under a second
# the JAX tests' engine policy: a page-starved pool (preemption fires) and
# short recovery backoffs
DC = dict(max_slots=3, page_size=4, max_context=40, prefill_chunk=8, num_pages=14,
          recovery_base_delay_s=0.001, recovery_max_delay_s=0.005,
          breaker_cooldown_s=0.05, breaker_max_cooldown_s=0.2)
# the host-tier tests' policy: room for the tree, prefix cache on
DC_PREFIX = dict(DC, num_pages=30, prefix_cache=True)


def _assert_margin(tparams, cfg, prompt, ref):
    from paddle_tpu_torch.models import transformer_lm as tlm

    with torch.no_grad():
        dec = tlm.CachedDecoder(tparams, cfg, 1, len(prompt) + len(ref))
        logits = [dec.prefill(torch.from_numpy(prompt[None]))]
        for s in range(len(ref) - 1):
            logits.append(dec.step(torch.tensor([int(ref[s])], dtype=torch.int32),
                                   len(prompt) + s))
    for s, lg in enumerate(logits):
        top2 = torch.topk(lg[0], 2).values
        assert float(top2[0] - top2[1]) > MARGIN, f"near tie at step {s}"
        assert int(torch.argmax(lg[0])) == int(ref[s])


@functools.lru_cache(maxsize=None)
def tiny_lm() -> types.SimpleNamespace:
    import jax.numpy as jnp

    from paddle_tpu import models as jmodels
    from paddle_tpu.framework import Variables as JVariables
    from paddle_tpu.serving import DecodeConfig as JDecodeConfig
    from paddle_tpu.serving import DecodeEngine as JDecodeEngine
    from paddle_tpu_torch import convert
    from paddle_tpu_torch import models as tmodels

    dims = dict(seq_len=64, vocab=VOCAB, d_model=32, d_inner=64, num_heads=4, n_layers=2)
    cfg = jmodels.get_model("transformer_lm", **dims).extra["cfg"]
    tspec = tmodels.get_model("transformer_lm", device="cpu", **dims)
    assert tspec.extra["cfg"] == cfg
    rng = np.random.RandomState(1)
    tparams = tspec.model.init(0, *tspec.synth_batch(2, rng), device="cpu").params
    jvars = JVariables({n: jnp.asarray(a) for n, a in convert.params_to_numpy(tparams).items()},
                       {})
    mixed = []
    for _ in range(3):
        tp = int(rng.randint(4, 12))
        n = int(rng.randint(8, 16))
        mixed.append((rng.randint(1, VOCAB, size=(tp,)).astype(np.int32), n))
    rng = np.random.RandomState(11)
    sys_prefix = rng.randint(1, VOCAB, size=(14,)).astype(np.int32)
    prefixed = []
    for _ in range(5):
        tail = rng.randint(1, VOCAB, size=(int(rng.randint(2, 8)),)).astype(np.int32)
        prefixed.append((np.concatenate([sys_prefix, tail]), int(rng.randint(6, 12))))
    # the JAX package's tokens: one engine, every prompt, no starvation
    eng = JDecodeEngine(jvars, cfg, decode=JDecodeConfig(max_slots=3, page_size=4,
                                                         max_context=40, prefill_chunk=8))
    try:
        handles = [eng.submit(p, n) for p, n in mixed + prefixed]
        refs = [np.asarray(h.result(timeout=WAIT_S).tokens) for h in handles]
    finally:
        eng.close(timeout=WAIT_S)
    for (p, _), r in zip(mixed + prefixed, refs):
        _assert_margin(tparams, cfg, p, r)
    return types.SimpleNamespace(
        cfg=cfg, jvars=jvars, params=tparams,
        mixed=[(p, n, r) for (p, n), r in zip(mixed, refs[:3])],
        prefixed=[(p, n, r) for (p, n), r in zip(prefixed, refs[3:])])


def port_engine(lm, label=None, pool=None, base=DC, **over):
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine, ServingConfig

    config = ServingConfig(engine_label=label) if label else None
    return DecodeEngine(lm.params, lm.cfg, config=config, decode=DecodeConfig(**dict(base, **over)),
                        host_tier=pool, device="cpu")


def jax_engine(lm, label=None, pool=None, base=DC, **over):
    from paddle_tpu.serving import DecodeConfig, DecodeEngine, ServingConfig

    config = ServingConfig(engine_label=label) if label else None
    return DecodeEngine(lm.jvars, lm.cfg, config=config, decode=DecodeConfig(**dict(base, **over)),
                        host_tier=pool)


def tokens(handles):
    """Each handle's tokens (a list of int lists), waiting WAIT_S at most."""
    return [np.asarray(h.result(timeout=WAIT_S).tokens).tolist() for h in handles]


def refs(cases):
    return [np.asarray(r).tolist() for _, _, r in cases]

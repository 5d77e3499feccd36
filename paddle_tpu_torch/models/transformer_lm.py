"""Decoder-only causal language model (GPT-style) — port of
``paddle_tpu/models/transformer_lm.py``: the training forward
(:func:`lm_forward`, trained through ``get_model(...).optimizer()``'s
``minimize``) and static-cache autoregressive decoding (:func:`generate`),
with the same parameter names, configuration and math.

Causal masking is structural: with ``flags().use_flash_attention`` the
prompt's attention (``lm_forward``, and ``generate``'s prefill, once per
layer) runs the hand-written flash kernels (``ops/cuda/flash_attention.py``:
the forward, and in training the dK/dV and dQ backward kernels). Decode
steps compose attention against the cache from einsums, as in the JAX
package.

``remat`` recomputes each layer in the backward pass
(:func:`~paddle_tpu_torch.framework.checkpoint`, replaying its names and
dropout masks). Not ported yet (they raise ``NotImplementedError``):
sequence parallelism (``ring_mesh``/``ulysses_mesh``), pipeline
parallelism (``pipe_mesh``), mixture-of-experts FFNs, beam search and the
paged serving functions. ``scan_layers`` runs as the plain layer loop,
whose math is identical.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import framework, layers, optimizer
from paddle_tpu_torch.core.config import on_device, resolve_device
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import name_scope
from paddle_tpu_torch.models import ModelSpec
from paddle_tpu_torch.models.transformer import (
    _post_process,
    _proj,
    multi_head_attention,
    positionwise_ffn,
    prepare_embedding,
    sinusoid_position_encoding,
)
from paddle_tpu_torch.ops.attention import (
    apply_rope,
    rope_tables,
    scaled_dot_product_attention,
)

__all__ = ["get_model", "lm_forward", "generate", "CachedDecoder", "BASE_CFG"]


def _check_ported(cfg: dict) -> None:
    """Raise for configuration knobs whose code paths are not ported yet."""
    missing = {
        "ring_mesh": "ring attention (ops/ring_attention.py)",
        "ulysses_mesh": "Ulysses attention (ops/ulysses.py)",
        "pipe_mesh": "pipeline parallelism (parallel/pipeline.py)",
        "moe_experts": "mixture-of-experts FFNs (parallel/moe.py)",
    }
    for key, what in missing.items():
        if cfg.get(key):
            raise NotImplementedError(
                f"transformer_lm cfg[{key!r}]: {what} is not ported to "
                "paddle_tpu_torch yet; it follows the main path"
            )


def _rope_core(cfg):
    """Attention core applying rotary position embeddings to q/k before the
    (flash-routed) fused attention."""

    def core(qh, kh, vh, kv_len=None):
        cos, sin = rope_tables(qh.shape[-1], qh.shape[-2], device=qh.device)
        return scaled_dot_product_attention(
            apply_rope(qh, cos, sin), apply_rope(kh, cos, sin), vh, causal=True,
            window=cfg.get("attention_window"), kv_len=kv_len,
        )

    return core


def lm_block(x, cfg, name, kv_len=None):
    """One decoder block: causal self-attention + FFN, post-LN."""
    core = _rope_core(cfg) if cfg.get("pos_encoding") == "rope" else None
    with name_scope(name):
        attn = multi_head_attention(
            x, x, x, cfg["d_model"], cfg["num_heads"],
            dropout_rate=cfg["attn_dropout"], causal=True, name="self_attn",
            core=core, num_kv_heads=cfg.get("num_kv_heads"),
            window=cfg.get("attention_window"), kv_len=kv_len,
        )
        x = _post_process(x, attn, cfg["residual_dropout"])
        ffn = positionwise_ffn(
            x, cfg["d_inner"], cfg["d_model"], cfg["relu_dropout"],
            activation=cfg.get("ffn_activation", "relu"),
        )
        return _post_process(x, ffn, cfg["residual_dropout"])


def lm_forward(ids, labels, seq_lens=None, *, cfg):
    """Next-token LM forward: returns ``(loss, token_count, logits)``.

    ``ids``/``labels`` are [B, T] int (tensors or arrays; they move to the
    model's device). ``seq_lens`` ([B] int, optional) marks suffix padding:
    attention masks key positions >= seq_lens[b] and the loss averages only
    positions p < seq_lens[b] - 1."""
    _check_ported(cfg)
    dev = framework.current_device()
    ids = torch.as_tensor(ids, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    if seq_lens is not None:
        seq_lens = torch.as_tensor(seq_lens, device=dev)
    x = prepare_embedding(
        ids, cfg["vocab"], cfg["d_model"], cfg["max_len"],
        cfg["residual_dropout"], name="emb",
        add_position_encoding=cfg.get("pos_encoding", "sinusoid") != "rope",
    )
    # remat only matters for the backward pass: init creates the parameters
    # and an eval apply keeps no activations
    remat = cfg.get("remat") and framework.is_training() and not framework.is_initializing()
    for i in range(cfg["n_layers"]):
        if remat:
            x = framework.checkpoint(functools.partial(
                lm_block, cfg=cfg, name=f"layer_{i}", kv_len=seq_lens), x)
        else:
            x = lm_block(x, cfg, name=f"layer_{i}", kv_len=seq_lens)
    x = layers.layer_norm(x, begin_norm_axis=x.dim() - 1)
    with name_scope("project"):
        logits = _proj(x, cfg["vocab"], shard_out=True, name="logits", bias=False)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if seq_lens is not None:
        valid = (torch.arange(labels.shape[1], device=dev)[None, :] < seq_lens[:, None] - 1).float()
        n_tok = torch.clamp_min(valid.sum(), 1.0)
        return (nll * valid).sum() / n_tok, n_tok, logits
    n_tok = float(np.prod(labels.shape))
    return nll.mean(), n_tok, logits


def _decode_ffn_fn(proj, swiglu: bool):
    """FFN for the cached decoder, pinned to ``positionwise_ffn``: relu(fc1)
    or fc1 * silu(gate)."""

    def ffn(x, i):
        if swiglu:
            h = proj(x, f"layer_{i}/ffn/fc1") * F.silu(proj(x, f"layer_{i}/ffn/gate"))
        else:
            h = torch.clamp_min(proj(x, f"layer_{i}/ffn/fc1"), 0)
        return proj(h, f"layer_{i}/ffn/fc2")

    return ffn


def _live_mask(t_max: int, t: int, window, device=None):
    """[t_max] bool mask of cache positions a token at position ``t`` may
    attend: <= t, and within the last ``window`` positions when sliding."""
    pos = torch.arange(t_max, device=device)
    live = pos <= t
    if window is not None:
        live &= pos > t - window
    return live


class CachedDecoder:
    """The static k/v-cache decoder behind :func:`generate`.

    Holds the parameters and a cache of ``[L, B, H_kv, t_max, dh]`` keys and
    values (``cache_dtype``, default f32). :meth:`prefill` runs the full
    causal pass over the prompt (flash-routed attention, once per layer),
    fills cache positions [0, Tp) and returns the next-token logits;
    :meth:`step` decodes one token at position ``t`` against the cache. The
    JAX package threads an immutable cache through ``lax.scan``; here the
    cache is updated in place, which saves a copy per token.
    """

    def __init__(self, params: dict, cfg: dict, batch: int, t_max: int, cache_dtype=None):
        _check_ported(cfg)
        self.params, self.cfg = params, cfg
        D, H, L = cfg["d_model"], cfg["num_heads"], cfg["n_layers"]
        self.D, self.H, self.L = D, H, L
        self.dh = D // H
        self.H_kv = cfg.get("num_kv_heads") or H  # GQA: cache holds H_kv heads
        self.G = H // self.H_kv
        self.t_max = t_max
        self.window = cfg.get("attention_window")
        self.rope = cfg.get("pos_encoding", "sinusoid") == "rope"
        dev = params["emb/embedding/word_emb"].device
        self.device = dev
        self.pe = sinusoid_position_encoding(max(cfg["max_len"], t_max), D, device=dev)
        if self.rope:
            self.rope_cos, self.rope_sin = rope_tables(self.dh, max(cfg["max_len"], t_max), device=dev)
        self.scale = 1.0 / np.sqrt(self.dh)
        cdt = cache_dtype or torch.float32
        shape = (L, batch, self.H_kv, t_max, self.dh)
        self.k_cache = torch.zeros(shape, dtype=cdt, device=dev)
        self.v_cache = torch.zeros(shape, dtype=cdt, device=dev)
        self.ffn = _decode_ffn_fn(self.proj, cfg.get("ffn_activation", "relu") == "swiglu")

    def ln(self, x, pfx):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5) * self.params[f"{pfx}/scale"] + self.params[f"{pfx}/bias"]

    def proj(self, x, pfx, bias=True):
        out = x @ self.params[f"{pfx}/w"]
        return out + self.params[f"{pfx}/b"] if bias else out

    def heads(self, x, n):  # [B, T, n*dh] -> [B, n, T, dh]
        return x.reshape(x.shape[0], x.shape[1], n, self.dh).permute(0, 2, 1, 3)

    def embed(self, ids, pos0: int):
        e = self.params["emb/embedding/word_emb"][ids.long()] * (self.D ** 0.5)
        if self.rope:  # position enters at the attention rotation instead
            return e
        return e + self.pe[pos0:pos0 + ids.shape[1]]

    def rotate(self, x, pos0: int):
        """RoPE at absolute positions [pos0, pos0+T): cached K is stored
        pre-rotated."""
        t = x.shape[2]
        return apply_rope(x, self.rope_cos[pos0:pos0 + t], self.rope_sin[pos0:pos0 + t])

    def block(self, x, i, attend, pos0: int):
        pfx = f"layer_{i}/self_attn"
        q = self.heads(self.proj(x, f"{pfx}/q"), self.H)
        k = self.heads(self.proj(x, f"{pfx}/k"), self.H_kv)
        v = self.heads(self.proj(x, f"{pfx}/v"), self.H_kv)
        if self.rope:
            q = self.rotate(q, pos0)
            k = self.rotate(k, pos0)
        ctx = attend(q, k, v, i)  # [B, H, Tq, dh]
        ctx = ctx.permute(0, 2, 1, 3).reshape(x.shape[0], x.shape[1], self.D)
        x = self.ln(x + self.proj(ctx, f"{pfx}/out"), f"layer_{i}/layer_norm")
        return self.ln(x + self.ffn(x, i), f"layer_{i}/layer_norm_1")

    def logits_of(self, x_last):  # [B, D] -> [B, vocab]
        return self.ln(x_last, "layer_norm") @ self.params["project/logits/w"]

    def prefill(self, prompt: torch.Tensor) -> torch.Tensor:
        """Full causal pass over ``prompt`` [B, Tp]; fills the cache at
        [0, Tp) and returns the logits [B, vocab] for position Tp."""
        tp = prompt.shape[1]

        def attend(q, k, v, i):
            self.k_cache[i, :, :, :tp] = k
            self.v_cache[i, :, :, :tp] = v
            return scaled_dot_product_attention(q, k, v, causal=True, window=self.window)

        x = self.embed(prompt, 0)
        for i in range(self.L):
            x = self.block(x, i, attend, pos0=0)
        return self.logits_of(x[:, -1])

    def step(self, tok: torch.Tensor, t: int) -> torch.Tensor:
        """One token ``tok`` [B] at position ``t`` against the cache; returns
        the logits [B, vocab] for position t + 1."""
        live = _live_mask(self.t_max, t, self.window, self.device)
        B = tok.shape[0]

        def attend(q, k, v, i):
            self.k_cache[i, :, :, t] = k[:, :, 0]
            self.v_cache[i, :, :, t] = v[:, :, 0]
            kci = self.k_cache[i].to(q.dtype)
            vci = self.v_cache[i].to(q.dtype)
            qg = q.reshape(B, self.H_kv, self.G, 1, self.dh)
            s = torch.einsum("bkgqd,bktd->bkgqt", qg, kci) * self.scale
            s = torch.where(live, s, -1e9)
            ctx = torch.einsum("bkgqt,bktd->bkgqd", torch.softmax(s, -1), vci)
            return ctx.reshape(B, self.H, 1, self.dh)

        y = self.embed(tok[:, None], t)
        for i in range(self.L):
            y = self.block(y, i, attend, pos0=t)
        return self.logits_of(y[:, -1])


def _sample(logits, temperature: float, top_k, top_p, generator):
    if temperature == 0.0:
        return torch.argmax(logits, -1).to(torch.int32)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p is not None:
        # nucleus: keep the smallest prefix of sorted probs with cumulative
        # mass >= top_p (the top token always survives)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep_sorted = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep_sorted, sorted_logits, torch.inf).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def generate(
    variables,
    prompt,
    max_new_tokens: int,
    cfg: dict,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    cache_dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> torch.Tensor:
    """Autoregressive decode with a static k/v cache — prefill once over the
    prompt, then one step per new token. Returns [B, max_new_tokens] int32.

    Greedy at ``temperature=0``; else softmax sampling (with ``top_k`` /
    ``top_p`` filtering) from ``generator``, a ``torch.Generator`` on the
    run's device (required then). ``device`` (default CUDA; raises if CUDA
    is absent unless ``device="cpu"``) must hold the parameters; the prompt
    moves there. ``cache_dtype`` (default f32): ``torch.bfloat16`` halves
    the cache's memory traffic."""
    enforce(max_new_tokens >= 1, f"max_new_tokens must be >= 1, got {max_new_tokens}")
    enforce(
        temperature == 0.0 or generator is not None,
        "generate: sampling (temperature > 0) needs an explicit torch.Generator — "
        "a silent fixed default would return identical 'samples' every call",
    )
    dev = resolve_device(device)
    params = variables.params if hasattr(variables, "params") else variables
    for name, value in params.items():
        enforce(on_device(value, dev),
                f"generate: parameter {name!r} is on {value.device}, not {dev}")
    prompt = torch.as_tensor(prompt, device=dev)
    B, tp = prompt.shape
    with torch.no_grad():
        dec = CachedDecoder(params, cfg, B, tp + max_new_tokens, cache_dtype)
        tok = _sample(dec.prefill(prompt), temperature, top_k, top_p, generator)
        toks = [tok]
        for s in range(max_new_tokens - 1):
            tok = _sample(dec.step(tok, tp + s), temperature, top_k, top_p, generator)
            toks.append(tok)
    return torch.stack(toks, dim=1)


BASE_CFG = dict(
    vocab=32000,
    d_model=512,
    d_inner=2048,
    num_heads=8,
    num_kv_heads=None,  # < num_heads -> grouped-query attention
    pos_encoding="sinusoid",  # or "rope" (rotary, applied at attention)
    ffn_activation="relu",  # or "swiglu"
    attention_window=None,  # int -> sliding-window attention (O(T*W))
    n_layers=6,
    max_len=8192,
    attn_dropout=0.0,
    relu_dropout=0.0,
    residual_dropout=0.0,
    remat=False,
    scan_layers=False,  # runs as the plain layer loop (identical math)
    moe_experts=0,
    moe_router="top1",
    moe_capacity_factor=1.25,
    moe_aux_weight=0.01,
)


def get_model(
    seq_len: int = 1024, learning_rate: float = 1e-3, ring_mesh=None,
    ulysses_mesh=None, device="cuda", **overrides
) -> ModelSpec:
    """The LM's spec at ``BASE_CFG`` with ``overrides``. ``device`` (default
    CUDA; raises if CUDA is absent unless ``device="cpu"``) is where
    ``synth_batch`` puts its tensors. ``ring_mesh``/``ulysses_mesh`` are not
    ported yet."""
    dev = resolve_device(device)
    cfg = dict(BASE_CFG)
    cfg.update({k: v for k, v in overrides.items() if k in cfg})
    cfg["max_len"] = max(cfg["max_len"], seq_len)
    for key, value in (("ring_mesh", ring_mesh), ("ulysses_mesh", ulysses_mesh),
                       ("pipe_mesh", overrides.get("pipe_mesh"))):
        if value is not None:
            cfg[key] = value
    _check_ported(cfg)

    model = framework.build(functools.partial(lm_forward, cfg=cfg), name="transformer_lm")

    def synth_batch(batch_size: int, rng: np.random.RandomState):
        ids = rng.randint(1, cfg["vocab"], size=(batch_size, seq_len)).astype(np.int32)
        labels = rng.randint(1, cfg["vocab"], size=(batch_size, seq_len)).astype(np.int32)
        return torch.as_tensor(ids, device=dev), torch.as_tensor(labels, device=dev)

    return ModelSpec(
        name="transformer_lm",
        model=model,
        synth_batch=synth_batch,
        optimizer=lambda: optimizer.Adam(learning_rate=learning_rate),
        unit="tokens/sec",
        examples_per_row=seq_len,
        extra={"cfg": cfg, "seq_len": seq_len, "device": dev, "learning_rate": learning_rate},
    )

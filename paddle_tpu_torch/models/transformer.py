"""Transformer NMT — port of ``paddle_tpu/models/transformer.py``: the
building blocks the decoder-only LM shares (projections, multi-head
attention with a decode-time k/v cache, the position-wise FFN, post-LN
residual blocks, the sinusoid embedding), the encoder-decoder itself
(:func:`encode`, :func:`decode`, :func:`transformer_forward`),
``BASE_CFG`` and :func:`get_model`. Parameter names and sharding
annotations match the JAX package.

Reference: the Transformer of ``benchmark/fluid`` (post-LN encoder-decoder,
d_model 512, 8 heads, ffn 2048, 6+6 layers, label smoothing 0.1, Adam +
Noam warmup). Padded [B, T] batches with pad flags replace LoD. With
``flags().use_flash_attention`` on, padding travels as per-row ``kv_len``
bounds and the decoder's causality as the kernel's structure
(:func:`_structural_masking`), so eval and dropout-free training run the
hand-written flash kernels on their non-causal ``kv_len`` path (encoder
self-attention, cross-attention) and their causal path (decoder
self-attention); training with attention dropout composes attention, as
the JAX package routes it. ``cfg["scan_layers"]`` runs as the plain layer
loop: the JAX package's ``scan_layer_stack`` reads the same per-layer
parameters (``enc_layer_{i}``/``dec_layer_{i}``), so names and math are
identical."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import framework, layers, lr_scheduler, optimizer
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.framework import ParamAttr, name_scope
from paddle_tpu_torch.models import ModelSpec
from paddle_tpu_torch.ops import attention as oattn
from paddle_tpu_torch.ops import nn as onn
from paddle_tpu_torch.parallel import context as dp_context

# canonical tensor-parallel mesh axis name (recorded in ParamAttr.sharding)
TP = "model"


def _proj(x, size, *, shard_out: bool, name: str, bias: bool = True):
    """Linear projection over the last axis of [B, T, D] with a tensor-
    parallel sharding annotation (column- or row-parallel)."""
    sharding = (None, TP) if shard_out else (TP, None)
    return layers.fc(
        x,
        size=size,
        num_flatten_dims=x.dim() - 1,
        param_attr=ParamAttr(sharding=sharding),
        bias_attr=None if bias else False,
        name=name,
    )


def multi_head_attention(
    queries,
    keys,
    values,
    d_model: int,
    num_heads: int,
    mask=None,
    dropout_rate: float = 0.0,
    cache: Optional[dict] = None,
    name: str = "mha",
    causal: bool = False,
    core=None,
    kv_len=None,
    num_kv_heads: Optional[int] = None,
    window: Optional[int] = None,
):
    """Projected multi-head attention (q/k/v/out linear maps + fused core).
    ``cache`` (decode-time) holds the accumulated k/v, ``{"k": [B,N,T,D],
    "v": ...}``: the new k/v are appended and written back into the dict.
    ``core`` overrides the attention core ``(qh, kh, vh, kv_len=None) -> ctx``
    (the RoPE core). ``num_kv_heads`` < num_heads is grouped-query
    attention."""
    h_kv = num_kv_heads or num_heads
    if num_heads % h_kv:
        raise ValueError(f"num_heads {num_heads} not divisible by num_kv_heads {h_kv}")
    d_kv = d_model // num_heads * h_kv
    with name_scope(name):
        q = _proj(queries, d_model, shard_out=True, name="q")
        k = _proj(keys, d_kv, shard_out=True, name="k")
        v = _proj(values, d_kv, shard_out=True, name="v")
        # under tensor parallelism this rank's heads: H/model query heads
        # and H_kv/model KV heads (the columns of q, k and v it holds)
        block = _head_block(q.shape[-1], d_model, num_heads, h_kv)
        n = block[2] if block else 1
        qh = oattn.split_heads(q, num_heads // n)
        kh = oattn.split_heads(k, h_kv // n)
        vh = oattn.split_heads(v, h_kv // n)
        if cache is not None:
            kh = torch.cat([cache["k"], kh], dim=2)
            vh = torch.cat([cache["v"], vh], dim=2)
            cache["k"], cache["v"] = kh, vh
        if core is not None:
            from paddle_tpu_torch.core.enforce import enforce

            enforce(
                mask is None
                and cache is None
                and (dropout_rate == 0.0 or not framework.is_training()),
                "multi_head_attention: a custom attention core supports neither "
                "an additive mask, nor a decode-time k/v cache, nor attention dropout",
            )
            ctx = core(qh, kh, vh, kv_len=kv_len)
        else:
            ctx = oattn.scaled_dot_product_attention(
                qh, kh, vh, mask=mask, dropout_rate=dropout_rate,
                is_test=not framework.is_training(), causal=causal,
                kv_len=kv_len, window=window, dropout_block=block,
            )
        out = oattn.combine_heads(ctx)
        return _proj(out, d_model, shard_out=False, name="out")


def _column_block(local: int, whole: int):
    """``(-1, index, n)`` of a column-parallel output holding ``local`` of
    ``whole`` features (this rank's block over the model axis), or None
    when it is whole."""
    if local == whole:
        return None
    from paddle_tpu_torch.parallel import collective

    n = whole // local
    return -1, collective.axis_index(TP), n


def _head_block(local: int, d_model: int, num_heads: int, h_kv: int):
    """The block of the heads (dim 1 of ``[B, H, T, d]``) a rank's q columns
    hold, or None when whole. Each rank must hold whole query and KV heads."""
    block = _column_block(local, d_model)
    if block is None:
        return None
    n = block[2]
    if num_heads % n or h_kv % n:
        raise ValueError(f"tensor parallelism over {n} ranks needs num_heads ({num_heads}) and "
                         f"num_kv_heads ({h_kv}) divisible by it")
    return 1, block[1], n


def _whole_columns(x, size: int):
    """A column-parallel output (the logits over the vocabulary) gathered
    whole on every rank of the model axis; the backward keeps this rank's
    columns of the gradient, which every rank computes alike."""
    if x.shape[-1] == size:
        return x
    from paddle_tpu_torch.parallel import collective

    return collective.gather_replicated(x, TP, -1)


def positionwise_ffn(x, d_inner: int, d_model: int, dropout_rate: float,
                     name: str = "ffn", activation: str = "relu"):
    """``activation='swiglu'`` gates the up-projection with a SiLU branch."""
    with name_scope(name):
        if activation == "swiglu":
            up = _proj(x, d_inner, shard_out=True, name="fc1")
            gate = _proj(x, d_inner, shard_out=True, name="gate")
            hidden = up * F.silu(gate)
        else:
            hidden = _proj(x, d_inner, shard_out=True, name="fc1")
            hidden = layers.relu(hidden)
        if dropout_rate:
            hidden = layers.dropout(hidden, dropout_rate,
                                    block=_column_block(hidden.shape[-1], d_inner))
        return _proj(hidden, d_model, shard_out=False, name="fc2")


def _post_process(prev, out, dropout_rate):
    """residual add + LayerNorm (post-LN, reference-era transformer)."""
    if dropout_rate:
        out = layers.dropout(out, dropout_rate)
    return layers.layer_norm(prev + out, begin_norm_axis=prev.dim() - 1)


def sinusoid_position_encoding(max_len: int, d_model: int, dtype=torch.float32, device=None):
    """[max_len, d_model] fixed encoding (computed in float64, then cast)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    dim = np.arange(d_model // 2)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * dim / d_model)
    enc = np.concatenate([np.sin(angle), np.cos(angle)], axis=1)
    return torch.as_tensor(enc, dtype=dtype, device=device)


@functools.lru_cache(maxsize=8)
def _cached_position_table(max_len: int, d_model: int, dtype, device):
    return sinusoid_position_encoding(max_len, d_model, dtype, device)


def _position_table(max_len: int, d_model: int, dtype, device):
    """:func:`sinusoid_position_encoding`, built once per shape, dtype and
    device and only read afterwards: it is a constant, and rebuilding it
    (float64 sin/cos on the host over all ``max_len`` rows) would add that
    host work to every forward, which the JAX package does once, at trace
    time. A traced call (``torch.export``) builds it afresh, so the cache
    never holds a traced tensor."""
    if torch.compiler.is_compiling():
        return sinusoid_position_encoding(max_len, d_model, dtype, device)
    return _cached_position_table(max_len, d_model, dtype, device)


def prepare_embedding(ids, vocab_size, d_model, max_len, dropout_rate, name,
                      pos_offset: int = 0, add_position_encoding: bool = True):
    """token embedding * sqrt(d) (+ fixed sinusoid position encoding unless
    ``add_position_encoding=False``). ``pos_offset`` shifts positions."""
    with name_scope(name):
        emb = layers.embedding(
            ids,
            size=[vocab_size, d_model],
            param_attr=ParamAttr(name="word_emb", sharding=(None, TP)),
        )
        emb = emb * (d_model ** 0.5)
        if add_position_encoding:
            t = ids.shape[-1]
            pe = _position_table(max_len, d_model, emb.dtype, emb.device)
            emb = emb + pe[pos_offset:pos_offset + t]
        if dropout_rate:
            emb = layers.dropout(emb, dropout_rate)
        return emb


def encoder_layer(x, self_mask, cfg, name, kv_len=None):
    with name_scope(name):
        attn = multi_head_attention(
            x, x, x, cfg["d_model"], cfg["num_heads"], mask=self_mask,
            dropout_rate=cfg["attn_dropout"], name="self_attn", kv_len=kv_len,
        )
        x = _post_process(x, attn, cfg["residual_dropout"])
        ffn = positionwise_ffn(x, cfg["d_inner"], cfg["d_model"], cfg["relu_dropout"])
        return _post_process(x, ffn, cfg["residual_dropout"])


def decoder_layer(x, enc_out, self_mask, cross_mask, cfg, name, cache=None,
                  self_causal=False, cross_kv_len=None):
    with name_scope(name):
        attn = multi_head_attention(
            x, x, x, cfg["d_model"], cfg["num_heads"], mask=self_mask,
            dropout_rate=cfg["attn_dropout"], cache=cache, name="self_attn",
            causal=self_causal,
        )
        x = _post_process(x, attn, cfg["residual_dropout"])
        cross = multi_head_attention(
            x, enc_out, enc_out, cfg["d_model"], cfg["num_heads"], mask=cross_mask,
            dropout_rate=cfg["attn_dropout"], name="cross_attn",
            kv_len=cross_kv_len,
        )
        x = _post_process(x, cross, cfg["residual_dropout"])
        ffn = positionwise_ffn(x, cfg["d_inner"], cfg["d_model"], cfg["relu_dropout"])
        return _post_process(x, ffn, cfg["residual_dropout"])


def _pad_mask(pad_flags):
    """[B, T] bool (True = padding) → additive [B, 1, 1, T]."""
    return torch.where(pad_flags, -torch.inf, 0.0).float()[:, None, None, :]


def _structural_masking() -> bool:
    """With the flash flag on, padding travels as per-row kv_len bounds and
    causality as the kernel's block structure — no additive [T, T] masks.
    Valid because padding is a SUFFIX and the loss zero-weights pad
    positions: pad QUERIES may compute values that never reach the loss,
    while pad KEYS are excluded for every valid query."""
    from paddle_tpu_torch.core import config as _cfg

    return _cfg.flags().use_flash_attention


def _lens(pad_flags):
    return (~pad_flags).sum(1).to(torch.int32)


def _on_device(x):
    return torch.as_tensor(x, device=framework.current_device())


def encode(src_ids, src_pad, cfg):
    src_ids, src_pad = _on_device(src_ids), _on_device(src_pad)
    structural = _structural_masking()
    self_mask = None if structural else _pad_mask(src_pad)
    src_len = _lens(src_pad) if structural else None
    x = prepare_embedding(
        src_ids, cfg["src_vocab"], cfg["d_model"], cfg["max_len"],
        cfg["residual_dropout"], name="src_emb",
    )
    for i in range(cfg["n_layers"]):
        x = encoder_layer(x, self_mask, cfg, name=f"enc_layer_{i}", kv_len=src_len)
    return x


def decode(trg_ids, trg_pad, enc_out, src_pad, cfg, caches=None, pos_offset: int = 0):
    """Decoder logits [B, T, trg_vocab]. ``caches`` (one ``{"k", "v"}`` dict
    per layer) runs incremental decoding: each layer's self-attention
    appends this call's k/v to its cache, and the target positions start at
    ``pos_offset``."""
    trg_ids, trg_pad, src_pad = _on_device(trg_ids), _on_device(trg_pad), _on_device(src_pad)
    t = trg_ids.shape[1]
    structural = _structural_masking() and caches is None
    if caches is not None or structural:
        # causal alone suffices for decoder self-attention: pad keys sit at
        # positions >= len, and every valid query q has q < len <= pad key
        # positions, so causality already excludes them
        self_mask = None
    else:
        self_mask = (oattn.causal_mask(t, t, device=trg_ids.device)[None, None]
                     + _pad_mask(trg_pad))
    cross_mask = None if structural else _pad_mask(src_pad)
    cross_len = _lens(src_pad) if structural else None
    x = prepare_embedding(
        trg_ids, cfg["trg_vocab"], cfg["d_model"], cfg["max_len"],
        cfg["residual_dropout"], name="trg_emb",
        pos_offset=pos_offset if caches is not None else 0,
    )
    for i in range(cfg["n_layers"]):
        cache = caches[i] if caches is not None else None
        x = decoder_layer(
            x, enc_out, self_mask, cross_mask, cfg, name=f"dec_layer_{i}",
            cache=cache, self_causal=structural, cross_kv_len=cross_len,
        )
    with name_scope("project"):
        logits = _proj(x, cfg["trg_vocab"], shard_out=True, name="logits", bias=False)
    return _whole_columns(logits, cfg["trg_vocab"])


def transformer_forward(src_ids, src_pad, trg_ids, trg_pad, labels, label_pad, *, cfg):
    """Training forward: returns (avg_loss, token_count, logits).

    Loss = label-smoothed softmax CE, averaged over non-pad tokens
    (reference transformer label_smooth eps=0.1)."""
    enc_out = encode(src_ids, src_pad, cfg)
    logits = decode(trg_ids, trg_pad, enc_out, src_pad, cfg)
    labels, label_pad = _on_device(labels), _on_device(label_pad)
    smooth = onn.label_smooth(onn.one_hot(labels, cfg["trg_vocab"]), cfg["label_smooth_eps"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_loss = -(smooth * logp).sum(-1)  # [B, T]
    weight = 1.0 - label_pad.float()
    # n_tok is the global batch's under DataParallel (parallel/context.py)
    n_tok = torch.clamp_min(dp_context.global_sum(weight.sum()), 1.0)
    avg_loss = dp_context.scale_ratio((tok_loss * weight).sum() / n_tok)
    return avg_loss, n_tok, logits


BASE_CFG = dict(
    src_vocab=10000,
    trg_vocab=10000,
    d_model=512,
    d_inner=2048,
    num_heads=8,
    n_layers=6,
    max_len=256,
    attn_dropout=0.1,
    relu_dropout=0.1,
    residual_dropout=0.1,
    label_smooth_eps=0.1,
    scan_layers=False,  # runs as the plain layer loop (identical math)
)


def get_model(seq_len: int = 64, learning_rate: float = 2.0, warmup_steps: int = 8000,
              device="cuda", **overrides):
    """The NMT Transformer's spec at ``BASE_CFG`` with ``overrides``: Adam
    (0.9, 0.98, 1e-9) with Noam decay. ``device`` (default CUDA; raises if
    CUDA is absent unless ``device="cpu"``) is where ``synth_batch`` puts
    its tensors: ``(src, src_pad, trg, trg_pad, labels, label_pad)`` with
    ragged lengths in [seq_len/2, seq_len] as suffix padding."""
    dev = resolve_device(device)
    cfg = dict(BASE_CFG)
    cfg.update({k: v for k, v in overrides.items() if k in cfg})

    model = framework.build(functools.partial(transformer_forward, cfg=cfg), name="transformer")

    def synth_batch(batch_size: int, rng: np.random.RandomState):
        src = rng.randint(1, cfg["src_vocab"], size=(batch_size, seq_len)).astype(np.int32)
        trg = rng.randint(1, cfg["trg_vocab"], size=(batch_size, seq_len)).astype(np.int32)
        labels = rng.randint(1, cfg["trg_vocab"], size=(batch_size, seq_len)).astype(np.int32)
        lens = rng.randint(seq_len // 2, seq_len + 1, size=(batch_size,))
        src_pad = np.arange(seq_len)[None, :] >= lens[:, None]
        return tuple(torch.as_tensor(a, device=dev)
                     for a in (src, src_pad, trg, src_pad.copy(), labels, src_pad.copy()))

    def make_optimizer():
        return optimizer.Adam(
            learning_rate=lr_scheduler.NoamDecay(cfg["d_model"], warmup_steps, learning_rate),
            beta1=0.9, beta2=0.98, epsilon=1e-9,
        )

    return ModelSpec(
        name="transformer",
        model=model,
        synth_batch=synth_batch,
        optimizer=make_optimizer,
        unit="tokens/sec",
        examples_per_row=seq_len,
        extra={"cfg": cfg, "seq_len": seq_len, "device": dev},
    )

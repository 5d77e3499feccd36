"""Decoder-only causal language model (GPT-style) — port of
``paddle_tpu/models/transformer_lm.py``: the training forward
(:func:`lm_forward`, trained through ``get_model(...).optimizer()``'s
``minimize``), static-cache autoregressive decoding (:func:`generate`,
:func:`generate_beam`) and the paged-cache functions the decode engine
serves through (:func:`paged_prefill_chunk`, :func:`paged_decode_step`,
:func:`paged_verify_step`), with the same parameter names, configuration
and math.

Causal masking is structural: with ``flags().use_flash_attention`` the
prompt's attention (``lm_forward``, and the prefill of ``generate`` and
``generate_beam``, once per layer) runs the hand-written flash kernels
(``ops/cuda/flash_attention.py``: the forward, and in training the dK/dV
and dQ backward kernels). Decode steps and the paged functions compose
attention from einsums, as in the JAX package. The decoders' f32 products
run in full f32 on the card (``core/dtypes.py::ieee_f32``).

``remat`` recomputes each layer in the backward pass
(:func:`~paddle_tpu_torch.framework.checkpoint`, replaying its names and
dropout masks). ``scan_layers`` runs as the plain layer loop, whose math is
identical. Pipeline parallelism (``pipe_mesh``) runs the layers as GPipe
stages over the mesh's ``pipe`` axis (:func:`_pipeline_lm_blocks`), and
tensor parallelism splits every projection, the embedding and the logits
over a ``model`` axis (``models/transformer.py``, ``layers.fc``). The two
compose as in the JAX package: on a ``pipe_mesh`` with a ``model`` axis
the embedding and the logits split over ``model`` and the stages run on
their whole weights, each rank on its rows of every microbatch. Beside
``model`` the ring and Ulysses run on each rank's block of the heads.

Sequence parallelism (``ring_mesh``/``ulysses_mesh``) runs in two modes:

- global arrays: ``Model.apply`` on the whole batch on every rank of the
  mesh (as the JAX package's tests call it): each attention core takes its
  rank's block of the sequence (and of the batch over ``data``), runs the
  ring (``ops/ring_attention.py``) or Ulysses (``ops/ulysses.py``) body,
  and gathers the result back;
- a rank's block: inside a ``DataParallel`` step whose batch specs split
  the sequence dim (``P("data", "seq")``), the core runs the per-rank body
  on the rank's segment with no gather, and embeddings, rope, the loss mask
  ``p < seq_lens[b] - 1``, the MoE token mask and ``n_tok`` use GLOBAL
  positions (``parallel/context.py``).

Mixture-of-experts FFNs (``moe_experts``, ``parallel/moe.py``) replace the
dense FFN; the router's aux loss joins the training loss (not eval's).
The cached decoders refuse them, as the JAX package's do.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import framework, layers, optimizer
from paddle_tpu_torch.core.config import on_device, resolve_device
from paddle_tpu_torch.core.dtypes import ieee_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import name_scope
from paddle_tpu_torch.models import ModelSpec
from paddle_tpu_torch.models.transformer import (
    _position_table,
    _post_process,
    _proj,
    _whole_columns,
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
from paddle_tpu_torch.parallel import context as dp_context
from paddle_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from paddle_tpu_torch.parallel.moe import moe_ffn

__all__ = [
    "get_model", "lm_forward", "generate", "generate_beam", "CachedDecoder", "PagedDecoder",
    "GroupPagedDecoder",
    "paged_cache_shape", "paged_prefill_chunk", "paged_decode_step", "paged_verify_step",
    "BASE_CFG",
]


def _check_decodable(cfg: dict, where: str) -> None:
    """The cached decoders' refusals (the JAX package's): MoE FFNs."""
    enforce(not cfg.get("moe_experts"),
            f"{where}: MoE FFNs are not supported in the cached decoders yet — decode with "
            "lm_forward teacher-forcing, or use a dense-FFN config")


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


def _seq_core(cfg):
    """The attention core of a sequence-parallel configuration (ring or
    Ulysses over cfg's mesh), or None. On a rank's block of the sequence
    (a sequence-sharded data-parallel step) it runs the per-rank body over
    the step's ``seq`` axis; on global arrays it shards and gathers (the
    batch dim too, unless a data-parallel step already split it)."""
    from paddle_tpu_torch.ops import ring_attention as ring
    from paddle_tpu_torch.ops import ulysses

    is_ring = cfg.get("ring_mesh") is not None
    if not is_ring and cfg.get("ulysses_mesh") is None:
        return None
    mesh = cfg["ring_mesh"] if is_ring else cfg["ulysses_mesh"]
    window = cfg.get("attention_window")

    def core(qh, kh, vh, kv_len=None):
        # beside tensor parallelism the rank holds its block of the heads;
        # Ulysses may need them whole (ops/ulysses.py)
        kw = {} if is_ring or qh.shape[1] == cfg["num_heads"] else {"head_axis": MODEL_AXIS}
        split = dp_context.seq_split()
        if split is not None:
            body = ring.ring_attention if is_ring else ulysses.ulysses_attention
            with split[0]:
                return body(qh, kh, vh, axis=split[1], causal=True, window=window,
                            kv_len=kv_len, **kw)
        sharded = ring.ring_attention_sharded if is_ring else ulysses.ulysses_attention_sharded
        batch_axis = None if dp_context.active() else DATA_AXIS
        return sharded(qh, kh, vh, mesh, causal=True, window=window, kv_len=kv_len,
                       batch_axis=batch_axis, **kw)

    return core


def _with_rope(core):
    """Wrap a sequence-parallel attention core with RoPE at GLOBAL
    positions (a rank's block starts at its segment's offset)."""

    def rotated(qh, kh, vh, kv_len=None):
        t = qh.shape[-2]
        cos, sin = rope_tables(qh.shape[-1], t, pos0=dp_context.seq_offset(t), device=qh.device)
        return core(apply_rope(qh, cos, sin), apply_rope(kh, cos, sin), vh, kv_len=kv_len)

    return rotated


def _positions(t: int, device) -> torch.Tensor:
    """The GLOBAL positions of a block's ``t`` tokens of each row."""
    return dp_context.seq_offset(t) + torch.arange(t, device=device)


def lm_block(x, cfg, name, kv_len=None):
    """One decoder block: causal self-attention + FFN (dense or
    mixture-of-experts), post-LN. Returns ``(x, aux_loss)`` — aux is the
    router load-balance loss when ``cfg['moe_experts']`` selects an MoE FFN
    (``parallel/moe.py``), else 0."""
    core = _seq_core(cfg)
    if core is None:
        enforce(dp_context.seq_split() is None,
                "transformer_lm: a batch split over the sequence dim needs a sequence-parallel "
                "attention core (ring_mesh or ulysses_mesh)")
    if cfg.get("pos_encoding") == "rope":
        core = _with_rope(core) if core is not None else _rope_core(cfg)
    with name_scope(name):
        attn = multi_head_attention(
            x, x, x, cfg["d_model"], cfg["num_heads"],
            dropout_rate=cfg["attn_dropout"], causal=True, name="self_attn",
            core=core, num_kv_heads=cfg.get("num_kv_heads"),
            window=cfg.get("attention_window"), kv_len=kv_len,
        )
        x = _post_process(x, attn, cfg["residual_dropout"])
        if cfg.get("moe_experts"):
            # ragged batches: padding tokens are masked out of routing so
            # they consume no expert capacity and don't skew the balance
            token_mask = None
            if kv_len is not None:
                token_mask = _positions(x.shape[-2], x.device)[None, :] < kv_len[:, None]
            mo = moe_ffn(
                x, num_experts=cfg["moe_experts"], d_ff=cfg["d_inner"],
                capacity_factor=cfg.get("moe_capacity_factor", 1.25),
                router=cfg.get("moe_router", "top1"), name="moe_ffn",
                token_mask=token_mask,
            )
            ffn, aux = mo.output, mo.aux_loss
        else:
            ffn = positionwise_ffn(
                x, cfg["d_inner"], cfg["d_model"], cfg["relu_dropout"],
                activation=cfg.get("ffn_activation", "relu"),
            )
            aux = torch.zeros((), device=x.device)
        return _post_process(x, ffn, cfg["residual_dropout"]), aux


def _pipeline_lm_blocks(x, cfg):
    """Run the layer stack pipeline-parallel over cfg['pipe_mesh']'s
    ``pipe`` axis: layers split into n_stages contiguous groups, each stage
    runs its group (the layers' parameters stacked ``[S, L/S, ...]``, a
    stage's slice standing in for ``layer_tpl`` through
    :func:`framework.overlay_frame`), and microbatch activations flow stage
    to stage through :func:`parallel.pipeline.pipeline_apply` (the GPipe
    schedule; ``cfg['remat']`` recomputes each step in the backward).
    Embedding and projection compute stays replicated across the stages
    (split over ``model`` where the mesh has it, as outside a pipeline).
    Inside a stage the layers run on their whole parameters: a block a
    rank holds over ``model`` is gathered at stage entry, and the
    microbatch rows split over ``model`` (and ``data`` on global arrays),
    as the JAX package's ``shard_map`` does (``pipeline.py:119-135``).
    Dense batches and deterministic layers only; both are enforced in
    :func:`lm_forward`, as in the JAX package."""
    from paddle_tpu_torch.parallel.mesh import PIPE_AXIS
    from paddle_tpu_torch.parallel.pipeline import pipeline_apply, split_microbatches

    mesh = cfg["pipe_mesh"]
    n_stages = mesh.shape[PIPE_AXIS]
    L = cfg["n_layers"]
    enforce(
        L % n_stages == 0,
        f"pipe parallelism needs n_layers ({L}) divisible by the pipe axis ({n_stages})",
    )
    lps = L // n_stages
    # [S, L/S, ...] per suffix: stage s runs index s
    stacked = {
        s: v.reshape((n_stages, lps) + tuple(v.shape[1:]))
        for s, v in framework.gather_layer_params(L, lambda i: f"layer_{i}").items()
    }
    # the dims of each stacked leaf this rank holds as a block (every layer
    # alike: layer 0's), two to the right of the parameter's own
    blocks = {s: [(d + 2, a) for d, a in framework.held_blocks(f"layer_0/{s}")] for s in stacked}

    def stage_fn(stage_params, h):
        for j in range(lps):
            with framework.overlay_frame({f"layer_tpl/{s}": v[j]
                                          for s, v in stage_params.items()}):
                # pipe stages carry activations only; MoE (whose aux loss
                # would be dropped here) is refused in lm_forward
                h, _ = lm_block(h, cfg, "layer_tpl", None)
        return h

    n_micro = int(cfg.get("pipe_n_micro") or 2 * n_stages)
    mbs = split_microbatches(x, n_micro)
    out = pipeline_apply(
        stage_fn, stacked, mbs, mesh,
        # remat matters only for the backward; in eval it is a pure slowdown
        remat=bool(cfg.get("remat")) and framework.is_training(), blocks=blocks,
    )
    return out.reshape(x.shape)


def lm_forward(ids, labels, seq_lens=None, *, cfg):
    """Next-token LM forward: returns ``(loss, token_count, logits)``.

    ``ids``/``labels`` are [B, T] int (tensors or arrays; they move to the
    model's device). ``seq_lens`` ([B] int, optional) marks suffix padding:
    attention masks key positions >= seq_lens[b] and the loss averages only
    positions p < seq_lens[b] - 1. In training, MoE configurations add
    ``moe_aux_weight`` times the routers' load-balance loss. With
    ``pipe_mesh`` the layers run as pipeline stages (init runs them as the
    plain loop), which refuses what the JAX package's does beside it."""
    dev = framework.current_device()
    ids = torch.as_tensor(ids, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    if seq_lens is not None:
        seq_lens = torch.as_tensor(seq_lens, device=dev)
    x = prepare_embedding(
        ids, cfg["vocab"], cfg["d_model"], cfg["max_len"],
        cfg["residual_dropout"], name="emb", pos_offset=dp_context.seq_offset(ids.shape[-1]),
        add_position_encoding=cfg.get("pos_encoding", "sinusoid") != "rope",
    )
    if cfg.get("moe_experts"):
        enforce(
            cfg.get("ffn_activation", "relu") == "relu",
            "moe_experts: expert FFNs are two-layer ReLU; "
            f"ffn_activation={cfg.get('ffn_activation')!r} is not supported "
            "in the MoE path (v1 scope)",
        )
        enforce(
            not cfg["relu_dropout"],
            "moe_experts: expert FFNs have no dropout; set relu_dropout=0 (v1 scope)",
        )
    # remat only matters for the backward pass: init creates the parameters
    # and an eval apply keeps no activations
    remat = cfg.get("remat") and framework.is_training() and not framework.is_initializing()
    aux_total = torch.zeros((), device=dev)
    # pipe_mesh subsumes scan_layers (each stage runs its layer group); init
    # stays the plain loop, which creates the per-layer names
    if cfg.get("pipe_mesh") is not None and not framework.is_initializing():
        enforce(
            cfg.get("ring_mesh") is None and cfg.get("ulysses_mesh") is None,
            "pipe_mesh: sequence parallelism (ring_mesh/ulysses_mesh) does "
            "not compose with the pipelined path (v1 scope)",
        )
        enforce(seq_lens is None,
                "pipe_mesh: ragged seq_lens unsupported in the pipelined path (v1 scope)")
        enforce(
            not (cfg["attn_dropout"] or cfg["relu_dropout"] or cfg["residual_dropout"]),
            "pipe_mesh: dropout must be 0 (the pipeline body is "
            "deterministic; no rng stream threads through the schedule)",
        )
        enforce(not cfg.get("moe_experts"),
                "pipe_mesh: MoE FFNs unsupported in the pipelined path "
                "(the stage schedule carries activations only, so the "
                "router aux loss would be dropped)")
        x = _pipeline_lm_blocks(x, cfg)
    else:
        for i in range(cfg["n_layers"]):
            if remat:
                x, aux = framework.checkpoint(functools.partial(
                    lm_block, cfg=cfg, name=f"layer_{i}", kv_len=seq_lens), x)
            else:
                x, aux = lm_block(x, cfg, name=f"layer_{i}", kv_len=seq_lens)
            aux_total = aux_total + aux
    x = layers.layer_norm(x, begin_norm_axis=x.dim() - 1)
    with name_scope("project"):
        logits = _whole_columns(
            _proj(x, cfg["vocab"], shard_out=True, name="logits", bias=False), cfg["vocab"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    # MoE router load-balance term (0 for dense-FFN configs) — a TRAINING
    # regularizer only: eval loss stays the pure NLL
    aux_term = (cfg.get("moe_aux_weight", 0.01) * aux_total if framework.is_training()
                else torch.zeros((), device=dev))
    if seq_lens is not None:
        pos = _positions(labels.shape[1], dev)
        valid = (pos[None, :] < seq_lens[:, None] - 1).float()
        # n_tok is the global batch's under DataParallel (parallel/context.py)
        n_tok = torch.clamp_min(dp_context.global_sum(valid.sum()), 1.0)
        return dp_context.scale_ratio((nll * valid).sum() / n_tok) + aux_term, n_tok, logits
    n_tok = dp_context.global_count(float(np.prod(labels.shape)))
    return nll.mean() + aux_term, n_tok, logits


def _decode_ffn_fn(proj, swiglu: bool):
    """FFN for the cached decoder, pinned to ``positionwise_ffn``: relu(fc1)
    or fc1 * silu(gate)."""

    def ffn(x, i):
        if swiglu:
            h = proj(x, f"layer_{i}/ffn/fc1") * F.silu(proj(x, f"layer_{i}/ffn/gate"))
        else:
            h = F.relu(proj(x, f"layer_{i}/ffn/fc1"))  # jax.nn.relu: gradient 0 at 0
        return proj(h, f"layer_{i}/ffn/fc2")

    return ffn


def _live_mask(t_max: int, t, window, device=None):
    """[t_max] bool mask of cache positions a token at position ``t`` may
    attend: <= t, and within the last ``window`` positions when sliding
    (``t`` an int, or a tensor of positions [..., 1] for a mask [..., t_max])."""
    pos = torch.arange(t_max, device=device)
    live = pos <= t
    if window is not None:
        live &= pos > t - window
    return live


class _DecoderOps:
    """The parameters, position tables and per-layer math shared by the
    cached decoders (:class:`CachedDecoder`, :class:`PagedDecoder`): the
    same parameter names and operations as the JAX package's inline copies
    in ``generate``, ``generate_beam`` and ``_paged_ops``. ``t_max`` is the
    longest position the tables must cover."""

    def __init__(self, params: dict, cfg: dict, t_max: int):
        _check_decodable(cfg, type(self).__name__)
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
        n_pos = max(cfg["max_len"], t_max)
        self.pe = _position_table(n_pos, D, torch.float32, dev)
        if self.rope:
            self.rope_cos, self.rope_sin = rope_tables(self.dh, n_pos, device=dev)
        self.scale = 1.0 / np.sqrt(self.dh)
        self.ffn = _decode_ffn_fn(self.proj, cfg.get("ffn_activation", "relu") == "swiglu")

    def ln(self, x, pfx):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5) * self.params[f"{pfx}/scale"] + self.params[f"{pfx}/bias"]

    def proj(self, x, pfx, bias=True):
        out = x @ self.params[f"{pfx}/w"]
        return out + self.params[f"{pfx}/b"] if bias else out

    def logits_of(self, x_last):  # [..., D] -> [..., vocab]
        return self.ln(x_last, "layer_norm") @ self.params["project/logits/w"]


class CachedDecoder(_DecoderOps):
    """The static k/v-cache decoder behind :func:`generate` and
    :func:`generate_beam`.

    Holds the parameters and a cache of ``[L, B, H_kv, t_max, dh]`` keys and
    values (``cache_dtype``, default f32). :meth:`prefill` runs the full
    causal pass over the prompt (flash-routed attention, once per layer),
    fills cache positions [0, Tp) and returns the next-token logits;
    :meth:`step` decodes one token at position ``t`` against the cache. The
    JAX package threads an immutable cache through ``lax.scan``; here the
    cache is updated in place, which saves a copy per token.
    """

    def __init__(self, params: dict, cfg: dict, batch: int, t_max: int, cache_dtype=None):
        super().__init__(params, cfg, t_max)
        cdt = cache_dtype or torch.float32
        shape = (self.L, batch, self.H_kv, t_max, self.dh)
        self.k_cache = torch.zeros(shape, dtype=cdt, device=self.device)
        self.v_cache = torch.zeros(shape, dtype=cdt, device=self.device)

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

    def fill(self, prompt: torch.Tensor) -> torch.Tensor:
        """Full causal pass over ``prompt`` [B, Tp]; fills the cache at
        [0, Tp) and returns the last layer's hidden states [B, Tp, D]."""
        tp = prompt.shape[1]

        def attend(q, k, v, i):
            self.k_cache[i, :, :, :tp] = k
            self.v_cache[i, :, :, :tp] = v
            return scaled_dot_product_attention(q, k, v, causal=True, window=self.window)

        x = self.embed(prompt, 0)
        for i in range(self.L):
            x = self.block(x, i, attend, pos0=0)
        return x

    def prefill(self, prompt: torch.Tensor) -> torch.Tensor:
        """:meth:`fill`, then the logits [B, vocab] for position Tp."""
        return self.logits_of(self.fill(prompt)[:, -1])

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


def _params_on(variables, dev: torch.device, where: str) -> dict:
    params = variables.params if hasattr(variables, "params") else variables
    for name, value in params.items():
        enforce(on_device(value, dev),
                f"{where}: parameter {name!r} is on {value.device}, not {dev}")
    return params



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
    _check_decodable(cfg, "generate")
    dev = resolve_device(device)
    params = _params_on(variables, dev, "generate")
    prompt = torch.as_tensor(prompt, device=dev)
    B, tp = prompt.shape
    with torch.no_grad(), ieee_f32():
        dec = CachedDecoder(params, cfg, B, tp + max_new_tokens, cache_dtype)
        tok = _sample(dec.prefill(prompt), temperature, top_k, top_p, generator)
        toks = [tok]
        for s in range(max_new_tokens - 1):
            tok = _sample(dec.step(tok, tp + s), temperature, top_k, top_p, generator)
            toks.append(tok)
    return torch.stack(toks, dim=1)


def generate_beam(
    variables,
    prompt,
    max_new_tokens: int,
    cfg: dict,
    beam_size: int = 4,
    eos_id: int = 1,
    length_penalty_alpha: float = 0.0,
    cache_dtype: Optional[torch.dtype] = None,
    device="cuda",
):
    """Beam-search continuation of ``prompt`` [B, Tp]: returns
    ``(sequences [B, beam, max_new_tokens], scores [B, beam])`` best-first.

    Built on :func:`~paddle_tpu_torch.ops.control_flow.beam_search` over the
    same static k/v cache as :func:`generate` (:class:`CachedDecoder`): the
    prompt minus its last token is prefilled into the cache (one causal,
    flash-routed attention call per layer, so with
    ``flags().use_flash_attention`` and a prefill length the flash tiling
    divides, one flash-forward launch per layer), each row's last prompt
    token seeds its beams, and every step attends against cache[0..t]. The
    cache's layer axis moves behind the batch axis, which the search tiles
    and reorders across beams. ``device`` as in :func:`generate`. The JAX
    package's ``stacked_params`` (for its layer scan) has no counterpart:
    ``scan_layers`` runs as the plain layer loop."""
    from paddle_tpu_torch.ops import control_flow as ocf

    enforce(max_new_tokens >= 1, f"max_new_tokens must be >= 1, got {max_new_tokens}")
    _check_decodable(cfg, "generate_beam")
    dev = resolve_device(device)
    params = _params_on(variables, dev, "generate_beam")
    prompt = torch.as_tensor(prompt, device=dev)
    B, tp = prompt.shape
    enforce(tp >= 1, "generate_beam needs a non-empty prompt")
    thead = tp - 1
    with torch.no_grad(), ieee_f32():
        dec = CachedDecoder(params, cfg, B, tp + max_new_tokens, cache_dtype)
        if thead > 0:
            dec.fill(prompt[:, :thead])
        t = thead

        def step_fn(carry, tokens):
            # the step writes position t of the beams' caches in place, then
            # the search gathers the carry into new tensors
            nonlocal t
            dec.k_cache, dec.v_cache = carry["k"].transpose(0, 1), carry["v"].transpose(0, 1)
            logits = dec.step(tokens, t)
            t += 1
            return carry, torch.log_softmax(logits.float(), -1)

        return ocf.beam_search(
            step_fn,
            {"k": dec.k_cache.transpose(0, 1), "v": dec.v_cache.transpose(0, 1)},
            batch_size=B,
            beam_size=beam_size,
            vocab_size=cfg["vocab"],
            max_len=max_new_tokens,
            bos_id=prompt[:, -1],
            eos_id=eos_id,
            length_penalty_alpha=length_penalty_alpha,
        )


# ---- paged decode (serving.kv_cache / serving.decode) ---------------------
#
# The paged variant of generate()'s cache read/write: K/V live in fixed-size
# pages ([L, num_pages, H_kv, page_size, dh]) and each sequence maps logical
# positions to physical pages through an int32 page-table row. Every tensor
# shape below is a function of static config (slot count, table width, page
# size), never of which requests are in flight, so continuous batching
# (admit/evict between steps) keeps one step shape. The JAX package threads
# the pages through each call functionally; here they are written in place
# and returned for the same call signature.


def paged_cache_shape(cfg: dict, num_pages: int, page_size: int):
    """Shape of ``k_pages``/``v_pages`` for ``cfg``:
    ``[L, num_pages, H_kv, page_size, dh]``."""
    H = cfg["num_heads"]
    H_kv = cfg.get("num_kv_heads") or H
    return (cfg["n_layers"], num_pages, H_kv, page_size, cfg["d_model"] // H)


class GroupPagedDecoder:
    """The paged-cache decoder behind ``serving.DecodeEngine``, over the
    members of a tensor-parallel replica group (``serving.shardgroup``);
    :class:`PagedDecoder` is its one-member case. Pages hold
    ``page_size`` positions and page tables are ``table_width`` wide.

    Every entry point takes ``N`` sequences of ``Q`` new tokens at absolute
    positions ``pos`` [N, Q], writes their K/V into their pages through
    ``tables`` [N, P] (pre-rotated K under RoPE, as :func:`generate` stores
    it), gathers each sequence's whole logical context back through its
    table and attends over it, masked by position (causal, and the sliding
    window when configured): a prefill chunk is N = 1, Q = C; a decode step
    Q = 1; a verify block Q = K + 1. Attention composes from einsums, as in
    the JAX package, which has no paged-attention kernel
    (``paddle_tpu/models/transformer_lm.py:867-870``). The gather
    materializes each sequence's ``[H_kv, P * page_size, dh]`` context per
    layer. Pages may be bf16 (storage); the math is f32.

    ``member_params`` holds, per member, what ``GroupLayout.shard_params``
    gave it (its block of each parameter, on its device); ``shapes`` the
    whole parameters' shapes. ``k_pages``/``v_pages`` are lists of the
    members' page tensors (one tensor for one member): ``[L, num_pages,
    H_kv/tp, page_size, dh]`` each when ``kv_split`` (the layout shards the
    head dim), whole otherwise.

    Member ``m`` owns the query heads ``[m H/tp, (m+1) H/tp)`` and the FFN
    columns ``[m F/tp, (m+1) F/tp)`` (member 0 owns all when ``tp`` does not
    divide ``H`` or ``F``), and computes the K/V heads its pages hold. At
    construction each member keeps, per parameter, the slice it computes
    with (``members``): a view of its own block where the block covers that
    slice, else the slice of the parameter gathered whole from every
    member's block, once, as GSPMD gathers it. So any layout serves:
    ``num_kv_heads=1`` at ``tp=2`` splits k/v's ``dh`` columns while the
    pages stay whole, and a layout that shards the embedding, a layer norm
    or the logits leaves each member the whole tensor. The row-parallel
    partials (attention out, FFN fc2) are the collective: brought to member
    0's device, summed in member order, the bias added once, and the sum
    copied to every other member, so the replicated hidden states are
    bit-equal on every member."""

    def __init__(self, member_params, shapes: dict, cfg: dict, page_size: int,
                 table_width: int, kv_split: bool):
        enforce(not cfg.get("scan_layers"),
                "paged decode: scan_layers is not supported in the paged path (as in "
                "the JAX package); use generate() for scan-layers decode")
        enforce(not cfg.get("moe_experts"),
                "paged decode: MoE FFNs are not supported in the cached decoders — "
                "use a dense-FFN config")
        blocks = list(member_params)
        tp = len(blocks)
        shapes = {k: tuple(v) for k, v in shapes.items()}
        H = cfg["num_heads"]
        H_kv = cfg.get("num_kv_heads") or H
        self.dh = cfg["d_model"] // H
        self.page_size, self.t_eff = page_size, table_width * page_size
        self.swiglu = cfg.get("ffn_activation", "relu") == "swiglu"

        def owned(n):  # each member's [lo, hi) of n units
            if n % tp == 0:
                return [(m * n // tp, (m + 1) * n // tp) for m in range(tp)]
            return [(0, n)] + [(0, 0)] * (tp - 1)

        self.q_heads = owned(H)
        self.kv_split = kv_split
        self.kv_heads = ([(m * H_kv // tp, (m + 1) * H_kv // tp) for m in range(tp)]
                         if kv_split else [(0, H_kv)] * tp)
        self.ffn_cols = owned(shapes["layer_0/ffn/fc1/w"][1])
        self.members = [self._held(m, blocks, shapes, cfg["n_layers"]) for m in range(tp)]
        self.ops = [_DecoderOps(p, cfg, self.t_eff) for p in self.members]
        self.devices = [o.device for o in self.ops]
        o = self.ops[0]
        self.D, self.H, self.H_kv, self.G, self.L = o.D, o.H, o.H_kv, o.G, o.L

    def _held(self, m: int, blocks, shapes: dict, n_layers: int) -> dict:
        """Member ``m``'s parameters as its step uses them: each the slice
        ``(dim, lo, hi)`` it computes with, whole where it needs all."""
        dh = self.dh
        q = (self.q_heads[m][0] * dh, self.q_heads[m][1] * dh)
        kv = (self.kv_heads[m][0] * dh, self.kv_heads[m][1] * dh)
        f = self.ffn_cols[m]
        need = {}
        for i in range(n_layers):
            attn, ffn = f"layer_{i}/self_attn", f"layer_{i}/ffn"
            for n, cols in (("q", q), ("k", kv), ("v", kv)):
                need[f"{attn}/{n}/w"], need[f"{attn}/{n}/b"] = (1,) + cols, (0,) + cols
            need[f"{attn}/out/w"] = (0,) + q
            for n in ("fc1", "gate"):
                need[f"{ffn}/{n}/w"], need[f"{ffn}/{n}/b"] = (1,) + f, (0,) + f
            need[f"{ffn}/fc2/w"] = (0,) + f
        dev = blocks[m]["emb/embedding/word_emb"].device
        held = {}
        for name, t in blocks[m].items():
            whole = shapes[name]
            split = [d for d in range(t.dim()) if t.shape[d] != whole[d]]
            enforce(len(split) <= 1,
                    f"group decode: {name}'s block {tuple(t.shape)} of {whole} is cut on "
                    "more than one dim")
            dim, lo, hi = need.get(name, (0, 0, whole[0]))  # (0, 0, n): used whole
            base = m * t.shape[dim] if split == [dim] else 0
            if hi == lo:  # a member that computes none of it
                t = t.new_empty(t.shape[:dim] + (0,) + t.shape[dim + 1:])
            elif split and not (split == [dim] and base <= lo and hi <= base + t.shape[dim]):
                # its block is not the slice it computes with: the slice of
                # the parameter gathered whole, once, from every member's block
                t = torch.cat([b[name].to(dev) for b in blocks], split[0])
                if (lo, hi) != (0, t.shape[dim]):
                    t = t.narrow(dim, lo, hi - lo).contiguous()
            elif (lo - base, hi - base) != (0, t.shape[dim]):
                t = t.narrow(dim, lo - base, hi - lo)
            held[name] = t
        return held

    def _cols(self, m, x, pfx):
        """Member ``m``'s columns of a column-parallel projection."""
        p = self.members[m]
        return x @ p[f"{pfx}/w"] + p[f"{pfx}/b"]

    def _psum(self, partials, bias_name: str):
        """The row-parallel reduction: the members' partials summed in
        member order on member 0's device, the replicated bias added once,
        and the sum copied to every other member (its own tensor, also on
        the same device)."""
        dev0 = self.devices[0]
        acc = None
        for p in partials:
            acc = p.to(dev0) if acc is None else acc + p.to(dev0)
        acc = acc + self.members[0][bias_name]
        return [acc] + [acc.to(dev, copy=True) for dev in self.devices[1:]]

    def _attend(self, m, q, k_pages_m, v_pages_m, i, tables, live, N, Q):
        """Member ``m``'s query heads against the K/V heads its pages hold:
        the context [N, Q, heads * dh]."""
        dh, G = self.dh, self.G
        qlo, qhi = self.q_heads[m]
        klo = self.kv_heads[m][0]
        hk = k_pages_m.shape[2]
        kl = k_pages_m[i][tables].permute(0, 2, 1, 3, 4).reshape(N, hk, self.t_eff, dh)
        vl = v_pages_m[i][tables].permute(0, 2, 1, 3, 4).reshape(N, hk, self.t_eff, dh)
        lo, hi = qlo // G, (qhi - 1) // G + 1  # the kv heads these q heads read
        nq, nk = qhi - qlo, hi - lo
        g = nq // nk
        if nq % nk == 0 and all((h - qlo) // g + lo == h // G for h in range(qlo, qhi)):
            kl, vl = kl[:, lo - klo:hi - klo], vl[:, lo - klo:hi - klo]
        else:  # q heads straddle kv groups unevenly: one kv row per q head
            idx = torch.tensor([h // G - klo for h in range(qlo, qhi)], device=kl.device)
            kl, vl, nk, g = kl[:, idx], vl[:, idx], nq, 1
        qg = q.permute(0, 2, 1, 3).reshape(N, nk, g, Q, dh)
        s = torch.einsum("nkgqd,nktd->nkgqt", qg, kl.to(q.dtype)) * self.ops[m].scale
        s = torch.where(live, s, -1e9)
        ctx = torch.einsum("nkgqt,nktd->nkgqd", torch.softmax(s, -1), vl.to(q.dtype))
        return ctx.reshape(N, nq, Q, dh).permute(0, 2, 1, 3).reshape(N, Q, nq * dh)

    def run(self, tokens, pos, tables, k_pages, v_pages):
        """``tokens``/``pos`` [N, Q], ``tables`` [N, P] → every member's
        last-layer hidden states [N, Q, D] (replicated: bit-equal); the
        members' pages are written in place."""
        if isinstance(k_pages, torch.Tensor):
            k_pages, v_pages = [k_pages], [v_pages]
        N, Q = pos.shape
        D, dh = self.D, self.dh
        x, args = [], []
        for m, (o, dev) in enumerate(zip(self.ops, self.devices)):
            tab, p = tables.to(dev).long(), pos.to(dev).long()
            h = o.params["emb/embedding/word_emb"][tokens.to(dev).long()] * (D ** 0.5)
            rot = None
            if o.rope:
                cos, sin = o.rope_cos[p][:, :, None], o.rope_sin[p][:, :, None]

                def rot(y, cos=cos, sin=sin):  # rotated at each token's own position
                    half = dh // 2
                    y1, y2 = y[..., :half].float(), y[..., half:].float()
                    return torch.cat([y1 * cos - y2 * sin, y1 * sin + y2 * cos], -1).to(y.dtype)
            else:
                h = h + o.pe[p]
            live = _live_mask(self.t_eff, p[..., None], o.window, dev)[:, None, None]
            x.append(h)
            args.append((tab, torch.gather(tab, 1, p // self.page_size), p % self.page_size,
                         live, rot))
        for i in range(self.L):
            pfx = f"layer_{i}/self_attn"
            partials = []
            for m in range(len(self.members)):
                tab, phys, off, live, rot = args[m]
                klo, khi = self.kv_heads[m]
                k = self._cols(m, x[m], f"{pfx}/k").reshape(N, Q, khi - klo, dh)
                v = self._cols(m, x[m], f"{pfx}/v").reshape(N, Q, khi - klo, dh)
                if rot is not None:
                    k = rot(k)
                # advanced indices around a slice: the indexed shape is
                # [N, Q, heads, dh], as NumPy's and JAX's ``.at[...]`` give it
                cdt = k_pages[m].dtype
                k_pages[m][i][phys, :, off] = k.to(cdt)
                v_pages[m][i][phys, :, off] = v.to(cdt)
                qlo, qhi = self.q_heads[m]
                if qhi == qlo:
                    continue
                q = self._cols(m, x[m], f"{pfx}/q").reshape(N, Q, qhi - qlo, dh)
                if rot is not None:
                    q = rot(q)
                ctx = self._attend(m, q, k_pages[m], v_pages[m], i, tab, live, N, Q)
                partials.append(ctx @ self.members[m][f"{pfx}/out/w"])
            y = self._psum(partials, f"{pfx}/out/b")
            x = [o.ln(xm + ym, f"layer_{i}/layer_norm") for o, xm, ym in zip(self.ops, x, y)]
            fpfx = f"layer_{i}/ffn"
            partials = []
            for m in range(len(self.members)):
                lo, hi = self.ffn_cols[m]
                if hi == lo:
                    continue
                if self.swiglu:
                    h = self._cols(m, x[m], f"{fpfx}/fc1") * F.silu(
                        self._cols(m, x[m], f"{fpfx}/gate"))
                else:
                    h = F.relu(self._cols(m, x[m], f"{fpfx}/fc1"))
                partials.append(h @ self.members[m][f"{fpfx}/fc2/w"])
            y = self._psum(partials, f"{fpfx}/fc2/b")
            x = [o.ln(xm + ym, f"layer_{i}/layer_norm_1") for o, xm, ym in zip(self.ops, x, y)]
        return x

    def prefill_chunk(self, tokens, pos0: int, last_index: int, page_table, k_pages, v_pages):
        """One sequence's chunk ``tokens`` [C] at positions [pos0, pos0+C)
        through ``page_table`` [P]: the logits [vocab] at chunk index
        ``last_index``, clamped into [0, C) as the JAX package's dynamic
        index clamps it (a chunk before the prompt's last ignores them), on
        member 0's device."""
        C = tokens.shape[0]
        pos = (pos0 + torch.arange(C, device=tokens.device))[None]
        x = self.run(tokens[None], pos, page_table[None], k_pages, v_pages)[0]
        return self.ops[0].logits_of(x[0, min(max(last_index, 0), C - 1)])

    def decode_step(self, tokens, positions, page_tables, k_pages, v_pages):
        """``tokens``/``positions`` [S], ``page_tables`` [S, P]: the logits
        [S, vocab] after each slot's token."""
        x = self.run(tokens[:, None], positions[:, None], page_tables, k_pages, v_pages)[0]
        return self.ops[0].logits_of(x[:, 0])

    def verify_step(self, tokens, positions, page_tables, k_pages, v_pages):
        """``tokens`` [S, K+1] at positions ``positions[s] .. +K``: the greedy
        argmax [S, K+1] after each position."""
        pos = positions.long()[:, None] + torch.arange(tokens.shape[1], device=tokens.device)
        x = self.run(tokens, pos, page_tables, k_pages, v_pages)[0]
        return torch.argmax(self.ops[0].logits_of(x), -1).to(torch.int32)


class PagedDecoder(GroupPagedDecoder):
    """:class:`GroupPagedDecoder` over one member: one model's whole
    parameters ``params`` on their device, and one ``k_pages``/``v_pages``
    tensor each ``[L, num_pages, H_kv, page_size, dh]``."""

    def __init__(self, params: dict, cfg: dict, page_size: int, table_width: int):
        super().__init__([params], {n: v.shape for n, v in params.items()}, cfg, page_size,
                         table_width, kv_split=False)


def _paged_sampling(temperature: float, generator) -> None:
    enforce(temperature == 0.0 or generator is not None,
            "paged decode: sampling (temperature > 0) needs an explicit torch.Generator")


def paged_prefill_chunk(params, tokens, pos0, last_index, page_table, k_pages, v_pages,
                        generator: Optional[torch.Generator] = None, *, cfg: dict,
                        page_size: int, temperature: float = 0.0, top_k=None, top_p=None):
    """Prefill ONE sequence's chunk into its pages: ``tokens`` [C] int at
    absolute positions ``[pos0, pos0+C)``, mapped through ``page_table``
    [P]. Returns ``(next_token, k_pages, v_pages)``: ``next_token`` (0-d
    int32) is sampled from the logits at chunk index ``last_index`` —
    meaningful only on the prompt's final chunk; the pages are the ones
    given, written in place. Queries at padded positions (>= the prompt
    end) write K/V that decode overwrites before ever attending to them,
    and their outputs are discarded. Greedy at ``temperature=0``, else
    sampled from ``generator`` (as :func:`generate`)."""
    params = params.params if hasattr(params, "params") else params
    _paged_sampling(temperature, generator)
    with torch.no_grad(), ieee_f32():
        dec = PagedDecoder(params, cfg, page_size, page_table.shape[0])
        logits = dec.prefill_chunk(tokens, int(pos0), int(last_index), page_table, k_pages, v_pages)
        tok = _sample(logits[None], temperature, top_k, top_p, generator)[0]
    return tok, k_pages, v_pages


def paged_decode_step(params, tokens, positions, page_tables, k_pages, v_pages,
                      generator: Optional[torch.Generator] = None, *, cfg: dict,
                      page_size: int, temperature: float = 0.0, top_k=None, top_p=None):
    """One decode iteration for ``S`` independent sequences against the
    paged cache: embed ``tokens`` [S] at per-slot absolute ``positions``
    [S], write each token's K/V into its slot's pages, attend over each
    slot's gathered context, and sample the next token. Returns
    ``(next_tokens [S] int32, k_pages, v_pages)``. Shapes depend only on
    (S, table width, page size, model config); inactive slots point at the
    scratch page, and their writes and outputs are garbage the engine
    ignores."""
    params = params.params if hasattr(params, "params") else params
    _paged_sampling(temperature, generator)
    with torch.no_grad(), ieee_f32():
        dec = PagedDecoder(params, cfg, page_size, page_tables.shape[1])
        logits = dec.decode_step(tokens, positions, page_tables, k_pages, v_pages)
        nxt = _sample(logits, temperature, top_k, top_p, generator)
    return nxt, k_pages, v_pages


def paged_verify_step(params, tokens, positions, page_tables, k_pages, v_pages, *,
                      cfg: dict, page_size: int):
    """One speculative verify iteration for ``S`` sequences: ``tokens``
    [S, K+1] holds slot ``s``'s last sampled token followed by its ``K``
    draft proposals, at positions ``positions[s] .. positions[s]+K``. All
    K+1 K/V rows are written, the block attends causally over the gathered
    context, and ``out`` [S, K+1] is the greedy argmax after each position:
    ``out[s, j]`` is what sequential decode would sample after consuming
    ``tokens[s, :j+1]``. Returns ``(out, k_pages, v_pages)``. Greedy only.
    Rejected draft positions need no rollback: their rows sit past the
    accepted frontier, masked until the next block overwrites them."""
    params = params.params if hasattr(params, "params") else params
    with torch.no_grad(), ieee_f32():
        dec = PagedDecoder(params, cfg, page_size, page_tables.shape[1])
        out = dec.verify_step(tokens, positions, page_tables, k_pages, v_pages)
    return out, k_pages, v_pages


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
    ``synth_batch`` puts its tensors. ``ring_mesh``: a Mesh with a ``seq``
    axis → attention runs as ring attention over it (sequence-parallel
    exact attention); ``ulysses_mesh``: the same through all-to-all head
    resharding (``ops/ulysses.py``). ``pipe_mesh``: a Mesh with a ``pipe``
    axis → the layers run as that many pipeline stages (GPipe,
    ``parallel/pipeline.py``) over ``pipe_n_micro`` microbatches (default
    twice the stages)."""
    dev = resolve_device(device)
    cfg = dict(BASE_CFG)
    cfg.update({k: v for k, v in overrides.items() if k in cfg})
    cfg["max_len"] = max(cfg["max_len"], seq_len)
    for key, value in (("ring_mesh", ring_mesh), ("ulysses_mesh", ulysses_mesh)):
        if value is not None:
            cfg[key] = value
    if overrides.get("pipe_mesh") is not None:
        cfg["pipe_mesh"] = overrides["pipe_mesh"]
        cfg["pipe_n_micro"] = overrides.get("pipe_n_micro")

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

"""Ring attention: exact attention over a sequence-sharded ring of ranks —
port of ``paddle_tpu/ops/ring_attention.py``.

Q/K/V are sharded over the ``seq`` mesh axis: each rank holds one block of
the sequence, computes attention of its Q block against one K/V block at a
time, and the K/V blocks travel around the ring, one block in flight per
step (``collective.ppermute``: point to point). Partials merge by the
online softmax, so nothing materializes the full [T, T] score matrix
(Liu et al., Ring Attention).

Two bodies, routed as in the JAX package (:func:`ring_attention`):

- the flash route (:class:`_RingFlash`, the JAX ``_ring_flash``
  custom_vjp): each live (Q block, K/V block) pair runs the hand-written
  flash forward at its GLOBAL offsets
  (``ops/cuda/flash_attention.py::flash_attention_with_lse``,
  ``q_off = rank·T_local``, ``k_off = kv_rank·T_local``) and the partials
  merge by logsumexp; the backward is a second ring of block backwards
  (``flash_attention_bwd_block``: the dK/dV and dQ kernels) against the
  global ``(out, lse)``, with dK/dV carriers that travel with K/V and land
  back home after one more shift;
- the composed route (:func:`_ring_composed`): einsums per block pair and
  autograd through the differentiable ``ppermute`` — the reference path.

A block pair wholly in the future of the local queries (causal), or wholly
left of every query's window, is dead (:func:`_ring_block_dead`: offsets
are ints on each rank, so a plain Python test): its kernels are not
launched, so the launches differ by rank (rank r of n launches r + 1
forward kernels a layer under causal masking). The exchanges never skip:
every rank makes the same collectives in the same order in the forward and
in the backward.

Kernel operands and the merged output are in the compute dtype (bf16
under ``flags().use_bf16_compute``, as ``ops/attention.py`` feeds the
flash kernel and returns its output); the merge and the gradient carriers
accumulate in f32. The JAX package keeps q and the merged output in f32;
on f32 operands the two are the same.

Beside tensor parallelism (a ``seq × model`` mesh) each rank holds its
block of the heads, and the ring runs within its ``seq`` group (the ranks
that share its ``model`` coordinate: a collective over ``seq`` reaches
only those) on its ``H/model`` query and ``H_kv/model`` KV heads. The JAX
package runs the ring on whole heads; per head the function is the same.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core.dtypes import NEG_INF, mxu_operands
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import mesh as mesh_mod

__all__ = ["ring_attention", "ring_attention_sharded"]


def _block_attn(q, k, v, bias):
    """Scores + online-softmax partials for one (Q-block, KV-block) pair.
    q: [B, H, Tq, d]; k/v: [B, H_kv, Tk, d] (H_kv < H = GQA, repeated
    here); bias broadcastable to [B, H, Tq, Tk]. Returns (m, l, o)."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    scores = scores + bias
    m = scores.amax(-1)  # [B, H, Tq]
    p = torch.exp(scores - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m, l, o


def _merge(m1, l1, o1, m2, l2, o2):
    """Merge two online-softmax partial results."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    o = o1 * a1[..., None] + o2 * a2[..., None]
    return m, l, o


def _kv_pair(k, v):
    """K and V as the one tensor a ring step sends."""
    return torch.stack([k, v])


def _ring_composed(q, k, v, axis: str, causal: bool, window=None, kv_len=None):
    """Composed-einsum ring body — the differentiable reference path
    (autograd through ``ppermute``). ``kv_len`` ([B] int, GLOBAL lengths)
    masks key positions >= kv_len[b]."""
    n_dev = collective.axis_size(axis)
    rank = collective.axis_index(axis)
    t_local = q.shape[2]
    dtype = q.dtype
    dev = q.device
    q32 = q.float()
    perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
    q_pos = rank * t_local + torch.arange(t_local, device=dev)  # global positions of Q rows

    def block_bias(i):
        # the kv block held at ring step i started at rank (rank - i) mod n
        kv_rank = (rank - i) % n_dev
        k_pos = kv_rank * t_local + torch.arange(t_local, device=dev)
        if causal:
            keep = q_pos[:, None] >= k_pos[None, :]
            if window is not None:  # sliding window over GLOBAL positions
                keep = keep & (q_pos[:, None] - k_pos[None, :] < window)
            bias = torch.where(keep, 0.0, NEG_INF)[None, None]
        else:
            bias = torch.zeros((1, 1, t_local, t_local), device=dev)
        if kv_len is not None:  # suffix padding at GLOBAL positions
            lenm = torch.where(k_pos[None, :] < kv_len.to(dev)[:, None], 0.0, NEG_INF)
            bias = bias + lenm[:, None, None, :]
        return bias

    kv = _kv_pair(k.float(), v.float())
    m, l, o = _block_attn(q32, kv[0], kv[1], block_bias(0))
    for i in range(1, n_dev):
        kv = collective.ppermute(kv, axis, perm)
        bm, bl, bo = _block_attn(q32, kv[0], kv[1], block_bias(i))
        m, l, o = _merge(m, l, o, bm, bl, bo)
    # l >= 1 (the row's maximum adds e^0), so the floor never ties and its
    # gradient is jnp.maximum's
    out = o / torch.clamp_min(l, 1e-20)[..., None]
    return out.to(dtype)


def _ring_block_dead(causal: bool, window, q_off: int, k_off: int, t_local: int) -> bool:
    """True when an entire (local-Q, ring-step-KV) block pair is masked —
    fully future under causal, or entirely left of every query's window;
    its kernels are then not launched."""
    if not causal:
        return False
    dead = k_off > q_off + t_local - 1
    if window is not None:
        dead = dead or (k_off + t_local - 1 < q_off - (window - 1))
    return dead


def _merge_normalized(o1, lse1, o2, lse2):
    """Merge two NORMALIZED partials (o_i = softmax-weighted values over
    block i, lse_i = logsumexp of its scores, [B, H, T, 1])."""
    m = torch.maximum(lse1, lse2)
    a1 = torch.exp(lse1 - m)
    a2 = torch.exp(lse2 - m)
    l = a1 + a2
    o = (o1 * a1 + o2 * a2) / l
    return o, m + torch.log(l)


def _flash_blocks(q, k):
    from paddle_tpu_torch.ops.attention import _flash_block

    return _flash_block(q.shape[-2]), _flash_block(k.shape[-2])


def _ring_flash_fwd(q, k, v, axis: str, causal: bool, window=None, kv_len=None):
    """Flash-kernel ring body: ``(out, lse)``, out in q's dtype, lse f32
    [B, H, T, 1]. Each live block pair runs the forward kernel AT ITS
    GLOBAL OFFSETS; a dead pair merges as zeros with lse = NEG_INF, as the
    JAX package's ``lax.cond`` gives it. The merged output is rounded to
    the compute dtype, as the single-device flash route returns the
    kernel's output (``ops/attention.py``), so the two routes feed the
    next layer, and the backward's Delta = rowsum(dO * O), the same
    values (identity in f32)."""
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention_with_lse

    n_dev = collective.axis_size(axis)
    rank = collective.axis_index(axis)
    t_local = q.shape[-2]
    dtype = q.dtype
    perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
    bq, bk = _flash_blocks(q, k)
    qc, kc, vc = (t.contiguous() for t in mxu_operands(q, k, v))
    q_off = rank * t_local

    def block(kk, vv, k_off):
        o, lse = flash_attention_with_lse(qc, kk, vv, causal=causal, block_q=bq, block_k=bk,
                                          window=window, kv_len=kv_len, q_off=q_off, k_off=k_off)
        return o.float(), lse

    o, lse = block(kc, vc, q_off)
    kv = _kv_pair(kc, vc)
    for i in range(1, n_dev):
        kv = collective.ppermute(kv, axis, perm)
        k_off = ((rank - i) % n_dev) * t_local
        if _ring_block_dead(causal, window, q_off, k_off, t_local):
            bo = torch.zeros_like(o)
            blse = torch.full_like(lse, NEG_INF)
        else:
            bo, blse = block(kv[0], kv[1], k_off)
        o, lse = _merge_normalized(o, lse, bo, blse)
    return o.to(qc.dtype).to(dtype), lse


def _ring_flash_bwd_ring(q, k, v, out, lse, g, axis: str, causal: bool, window=None,
                         kv_len=None):
    """Fused-backward ring: each live ring step runs the block backward (the
    dK/dV and dQ kernels) AT ITS GLOBAL OFFSETS against the GLOBAL
    ``(out, lse)``, so per-block contributions are exact and independent.
    dQ accumulates locally in f32; dK/dV accumulate in f32 carriers that
    travel WITH K/V, so after the full cycle (n-1 steps + one final shift)
    each block's gradient is back at its home rank."""
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention_bwd_block

    n_dev = collective.axis_size(axis)
    rank = collective.axis_index(axis)
    t_local = q.shape[-2]
    perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
    bq, bk = _flash_blocks(q, k)
    qc, kc, vc = (t.contiguous() for t in mxu_operands(q, k, v))
    gc = g.to(qc.dtype).contiguous()
    out32 = out.float()
    q_off = rank * t_local

    def block(kk, vv, k_off):
        dq, dk, dv = flash_attention_bwd_block(
            qc, kk, vv, out32, lse, gc, causal=causal, block_q=bq, block_k=bk,
            window=window, kv_len=kv_len, q_off=q_off, k_off=k_off)
        return dq.float(), dk.float(), dv.float()

    dq, dk, dv = block(kc, vc, q_off)
    kv, dkv = _kv_pair(kc, vc), _kv_pair(dk, dv)
    for i in range(1, n_dev):
        kv = collective.ppermute(kv, axis, perm)
        dkv = collective.ppermute(dkv, axis, perm)
        k_off = ((rank - i) % n_dev) * t_local
        if not _ring_block_dead(causal, window, q_off, k_off, t_local):
            bdq, bdk, bdv = block(kv[0], kv[1], k_off)
            dq = dq + bdq
            dkv = dkv + _kv_pair(bdk, bdv)
    # K/V have travelled n-1 steps; one more shift lands each block's
    # accumulated gradient on its home rank
    dkv = collective.ppermute(dkv, axis, perm)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The flash ring's custom gradient (the JAX package's ``_ring_flash``
    custom_vjp): the forward saves ``q, k, v, out, lse``; the backward runs
    the block-backward ring. The mesh is re-entered in the backward, which
    autograd may run on another thread. ``kv_len`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, axis, causal, window):
        out, lse = _ring_flash_fwd(q, k, v, axis, causal, window, kv_len)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.axis, ctx.causal, ctx.window = axis, causal, window
        ctx.mesh = mesh_mod.current_mesh()
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        with ctx.mesh, torch.no_grad():
            dq, dk, dv = _ring_flash_bwd_ring(q, k, v, out, lse, g, ctx.axis, ctx.causal,
                                              ctx.window, kv_len)
        return dq, dk, dv, None, None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: str,
    causal: bool = False,
    use_flash: Optional[bool] = None,
    window: Optional[int] = None,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-rank body (the ranks of ``axis`` of the current mesh each call
    it on their block of the sequence). q/k/v: [B, H, T_local, d].
    Returns [B, H, T_local, d] — exact softmax(QK^T)V over the GLOBAL
    sequence.

    ``use_flash`` (default: ``flags().use_flash_attention``) runs each
    block pair through the flash kernels, forward AND backward, when the
    flash tiling takes both lengths (``ops/attention.py::_flash_block``,
    the JAX routing rule); else the composed ring. ``window`` (sliding
    window, causal only) and ``kv_len`` ([B] GLOBAL lengths) act on global
    positions on either route. Gradients for queries at positions >=
    kv_len[b] are exact only when the incoming cotangent is zero there (the
    loss masks pad positions)."""
    if use_flash is None:
        from paddle_tpu_torch.core.config import flags

        use_flash = flags().use_flash_attention
    if window is not None:
        enforce(causal, "ring_attention: window requires causal=True")
    if use_flash and q.dim() == 4:
        bq, bk = _flash_blocks(q, k)
        if bq and bk:
            lens = None if kv_len is None else torch.as_tensor(kv_len).to(torch.int32)
            return _RingFlash.apply(q, k, v, lens, axis, causal, window)
    return _ring_composed(q, k, v, axis, causal, window, kv_len)


def _batch_axis(q, mesh, batch_axis: Optional[str], what: str) -> Optional[str]:
    """The mesh axis the batch dim shards over: ``batch_axis`` when the mesh
    has it and it divides the batch, else None (the batch replicated)."""
    b_axis = batch_axis if (batch_axis and batch_axis in mesh.axis_names) else None
    if b_axis is not None and q.shape[0] % mesh.shape[b_axis] != 0:
        ptlog.warning(
            "%s: batch %d not divisible by mesh axis %r (size %d) — replicating the batch "
            "across it (%dx redundant attention compute); pad the batch to restore data "
            "parallelism", what, q.shape[0], b_axis, mesh.shape[b_axis], mesh.shape[b_axis])
        b_axis = None
    return b_axis


def sharded_call(body, q, k, v, mesh, axis: str, b_axis: Optional[str], kv_len):
    """Run a per-rank ``body(q, k, v, kv_len)`` on GLOBAL [B, H, T, d]
    tensors that every rank of ``mesh`` holds: each rank takes its block —
    T over ``axis``, B over ``b_axis`` (when not None) — and every rank gets
    the global result back (``shard_map`` with replicated inputs and
    output). Gradients reach every rank whole."""
    with mesh:
        blocks = []
        for t in (q, k, v):
            t = collective.shard_replicated(t, axis, 2)
            if b_axis is not None:
                t = collective.shard_replicated(t, b_axis, 0)
            blocks.append(t)
        if kv_len is not None and b_axis is not None:
            n = kv_len.shape[0] // mesh.shape[b_axis]
            kv_len = kv_len[collective.axis_index(b_axis) * n:][:n]
        out = body(*blocks, kv_len)
        if b_axis is not None:
            out = collective.gather_replicated(out, b_axis, 0)
        return collective.gather_replicated(out, axis, 2)


def ring_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = mesh_mod.SEQ_AXIS,
    causal: bool = False,
    use_flash: Optional[bool] = None,
    batch_axis: Optional[str] = mesh_mod.DATA_AXIS,
    window: Optional[int] = None,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Convenience wrapper: q/k/v are GLOBAL [B, H, T, d] tensors, the same
    on every rank of ``mesh``; shards the T dim over ``axis`` (and the batch
    dim over ``batch_axis`` when the mesh has it — each data group then
    rings only its own batch shard), runs :func:`ring_attention` and
    returns the global result on every rank. ``kv_len``: [B] GLOBAL
    sequence lengths (sharded with the batch)."""
    b_axis = _batch_axis(q, mesh, batch_axis, "ring_attention_sharded")

    def body(q_, k_, v_, kl):
        return ring_attention(q_, k_, v_, axis=axis, causal=causal, use_flash=use_flash,
                              window=window, kv_len=kl)

    return sharded_call(body, q, k, v, mesh, axis, b_axis, kv_len)

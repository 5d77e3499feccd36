"""Ulysses-style all-to-all sequence parallelism for attention — port of
``paddle_tpu/ops/ulysses.py``.

The second long-context path next to :mod:`~paddle_tpu_torch.ops.ring_attention`:
instead of passing K/V blocks around a ring, two ``all_to_all`` exchanges
re-shard the activations from sequence-sharded to HEAD-sharded, ordinary
(flash) attention runs on full sequences locally, and a third shards back
(DeepSpeed-Ulysses). Trade-off against the ring:

- communication is all-to-alls of the activations, independent of T's
  square;
- every rank sees the FULL sequence for its head slice, so the local kernel
  is the plain flash forward (``ops/cuda/flash_attention.py``), and its
  backward the fused dK/dV and dQ kernels;
- requires num_heads % n_ranks == 0 (the ring has no such constraint).

Beside tensor parallelism (a ``seq × model`` mesh) each rank holds its
block of the heads (``H/model`` query and ``H_kv/model`` KV heads) and the
exchanges run within its ``seq`` group, the ranks that share its ``model``
coordinate, on those heads. The JAX package runs the core on whole heads
(its ``shard_map`` spec leaves the head dim whole); per head the function
is the same. Where the rank's heads do not split over the ``seq`` axis
but the whole heads do, the core takes the whole heads (gathered over
``head_axis``) and keeps the rank's block of the result, as the JAX
package would run it; where the whole heads do not split either, the JAX
package's error.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core.dtypes import mxu_operands
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.ring_attention import sharded_call
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import mesh as mesh_mod

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def _flash(q, k, v, causal, window, kv_len):
    """The flash kernel on operands in the compute dtype, the result in
    q's dtype (as ``ops/attention.py`` routes it)."""
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention

    qc, kc, vc = (t.contiguous() for t in mxu_operands(q, k, v))
    return flash_attention(qc, kc, vc, causal=causal, window=window, kv_len=kv_len).to(q.dtype)


def _local_attention(q, k, v, causal: bool, use_flash: Optional[bool], window=None,
                     kv_len=None):
    from paddle_tpu_torch.core import config as _cfg

    flash = use_flash if use_flash is not None else _cfg.flags().use_flash_attention
    if flash:
        t = q.shape[-2]
        if t % 128 and t > 128:
            # pad T up to the next 128 multiple (the JAX package's flash
            # tiling): padded KEYS are masked via kv_len (reduced to the
            # real length), padded QUERY rows are sliced off below
            pad = (-t) % 128
            qp, kp, vp = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
            real = torch.full((q.shape[0],), t, dtype=torch.int32, device=q.device)
            eff_len = real if kv_len is None else torch.minimum(kv_len.to(real), real)
            ptlog.vlog(1, "ulysses: padding T=%d to %d for the flash kernel", t, t + pad)
            return _flash(qp, kp, vp, causal, window, eff_len)[..., :t, :]
        if t % 128 == 0 or t <= 128:
            return _flash(q, k, v, causal, window, kv_len)
    from paddle_tpu_torch.ops.cuda.flash_attention import _reference_attention

    return _reference_attention(q, k, v, causal, q.shape[-1] ** -0.5, window=window,
                                kv_len=kv_len)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: str = mesh_mod.SEQ_AXIS,
    causal: bool = False,
    use_flash: Optional[bool] = None,
    window: Optional[int] = None,
    kv_len: Optional[torch.Tensor] = None,
    head_axis: Optional[str] = None,
) -> torch.Tensor:
    """Per-rank body: q/k/v are LOCAL [B, H, T_local, d] blocks of the
    sequence, sharded over ``axis`` of the current mesh. Returns the local
    [B, H, T_local, d] output block.

    all_to_all #1: seq-sharded -> head-sharded ([B, H/n, T, d]); local
    full-sequence attention; all_to_all #2: back. ``kv_len``: [B] GLOBAL
    lengths — after the first exchange the local sequence IS global, so
    the kernel's kv_len masking applies directly. ``head_axis``: the mesh
    axis the heads are split over (this rank holds its block of them), or
    None when they are whole (module docstring)."""
    n = collective.axis_size(axis)
    if head_axis is not None and (q.shape[1] % n or k.shape[1] % n):
        whole = [collective.gather_replicated(t, head_axis, 1) for t in (q, k, v)]
        out = ulysses_attention(*whole, axis=axis, causal=causal, use_flash=use_flash,
                                window=window, kv_len=kv_len)
        return collective.shard_replicated(out, head_axis, 1)
    enforce(q.shape[1] % n == 0, f"num_heads {q.shape[1]} not divisible by {axis} size {n}")
    enforce(k.shape[1] % n == 0,
            f"kv heads {k.shape[1]} not divisible by {axis} size {n} (GQA "
            "under ulysses needs num_kv_heads % seq-axis == 0; use ring "
            "attention otherwise)")
    # split the head dim across the axis, gather the seq dim
    qh = collective.all_to_all(q, axis, split_axis=1, concat_axis=2)
    kh = collective.all_to_all(k, axis, split_axis=1, concat_axis=2)
    vh = collective.all_to_all(v, axis, split_axis=1, concat_axis=2)
    out = _local_attention(qh, kh, vh, causal, use_flash, window, kv_len)
    # inverse: split seq back out, gather heads
    return collective.all_to_all(out, axis, split_axis=2, concat_axis=1)


def ulysses_attention_sharded(
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
    head_axis: Optional[str] = None,
) -> torch.Tensor:
    """Convenience wrapper mirroring
    :func:`~paddle_tpu_torch.ops.ring_attention.ring_attention_sharded`:
    q/k/v are GLOBAL [B, H, T, d], the same on every rank (of a
    ``head_axis`` group: its block of the heads); shards T over ``axis``
    (and batch over ``batch_axis`` when present and divisible), runs
    :func:`ulysses_attention`, returns the global result on every rank.
    ``kv_len``: [B] GLOBAL lengths (sharded with the batch)."""
    b_axis = batch_axis if (batch_axis and batch_axis in mesh.axis_names) else None
    if b_axis is not None and q.shape[0] % mesh.shape[b_axis] != 0:
        b_axis = None

    def body(q_, k_, v_, kl):
        return ulysses_attention(q_, k_, v_, axis=axis, causal=causal, use_flash=use_flash,
                                 window=window, kv_len=kl, head_axis=head_axis)

    return sharded_call(body, q, k, v, mesh, axis, b_axis, kv_len)

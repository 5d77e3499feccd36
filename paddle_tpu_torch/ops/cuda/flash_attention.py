"""Flash attention: the hand-written Hopper kernels and their plain PyTorch
versions.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``. Its four Pallas TPU
kernels become three CUDA C++ kernels (each source note gives the design
and its bound on an H100):

- ``_flash_fwd_kernel`` (:67, streamed) and ``_flash_fwd_kernel_resident``
  (:139) become ONE kernel, ``csrc/flash_fwd.cu``;
- ``_flash_bwd_dkv_kernel`` (:362) becomes ``csrc/flash_bwd_dkv.cu``;
- ``_flash_bwd_dq_kernel`` (:434) becomes ``csrc/flash_bwd_dq.cu``.

For CUDA tensors the wrappers launch those kernels or raise; for CPU
tensors they run the plain versions (:func:`_reference_attention_with_lse`,
:func:`_flash_bwd_dkv_reference`, :func:`_flash_bwd_dq_reference`), which
are what the CPU tests hold against the JAX package. :func:`flash_attention`
is a ``torch.autograd.Function``: its backward runs the two fused kernels
under ``flags().flash_fused_bwd``, else autograd through
:func:`_reference_attention` (the recomputed backward, no kernel).

Block sizes: the Hopper kernels tile q rows and keys themselves (bf16: the
forward and dQ 128 q rows, dK/dV 128 keys) and take any T and
T_kv. ``block_q``/``block_k`` and the :func:`resolve_blocks`/
:func:`fit_block` chain keep the JAX signature and resolution order, so
callers run unchanged; they size the TPU's VMEM tiles and do not change the
Hopper kernels' tiling.

Export: the forward is also registered as the PyTorch operator
``paddle_tpu_torch::flash_fwd`` (:func:`flash_fwd_op`, with a fake
implementation that gives ``out``'s and ``lse``'s shapes and dtypes). A
call traced by ``torch.export`` records that operator, so an exported
inference program calls the hand-written kernel when it runs on the card.

Cost report: a ``TorchDispatchMode`` does not see a ``ctypes`` launch, so
while a step is counted (:class:`paddle_tpu_torch.observability.mfu.CostCounter`)
the wrappers report each call's model FLOPs and bytes themselves
(:func:`_report_costs`): the forward 4·B·H·d·(live q·k pairs), the
backward 2.5 times that. On the CPU the plain versions then run with the
counter paused, so a step counts the same FLOPs on either device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.dtypes import NEG_INF
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import mfu
from paddle_tpu_torch.ops.cuda.build import CudaKernel

__all__ = [
    "flash_attention",
    "flash_attention_with_lse",
    "flash_attention_bwd_block",
    "flash_fwd_op",
    "fit_block",
    "resolve_blocks",
    "tuned_blocks",
    "FLASH_FWD",
    "FLASH_BWD_DKV",
    "FLASH_BWD_DQ",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# the shape/mask arguments every launcher takes after its pointers:
# B, H, H_kv, T, T_kv, d, is_bf16, causal, window, q_off, k_off, sm_scale, stream
_SHAPE_ARGS = [_I] * 11 + [ctypes.c_float, _P]
FLASH_FWD = CudaKernel(
    "flash_fwd", "flash_fwd.cu", "flash_fwd",
    # q, k, v, out, lse, kv_len, ...
    [_P] * 6 + _SHAPE_ARGS,
)
FLASH_BWD_DKV = CudaKernel(
    "flash_bwd_dkv", "flash_bwd_dkv.cu", "flash_bwd_dkv",
    # q, k, v, dout, lse, delta, dk, dv, kv_len, ...
    [_P] * 9 + _SHAPE_ARGS,
)
FLASH_BWD_DQ = CudaKernel(
    "flash_bwd_dq", "flash_bwd_dq.cu", "flash_bwd_dq",
    # q, k, v, dout, lse, delta, dq, kv_len, ...
    [_P] * 8 + _SHAPE_ARGS,
)
_HEAD_DIMS = (32, 64, 128)


def fit_block(block: int, total: int) -> int:
    """Largest block <= ``block`` that divides ``total``, preferring
    multiples of 128, then multiples of 8 (the JAX package's TPU tiling
    policy, kept so block resolution agrees between the two packages)."""
    total = int(total)
    block = max(1, min(int(block), total))
    if total % block == 0:
        return block
    best_8 = best_any = 0
    for b in range(block, 0, -1):
        if total % b:
            continue
        if b % 128 == 0:
            return b
        if not best_8 and b % 8 == 0:
            best_8 = b
        if not best_any:
            best_any = b
    return best_8 or best_any or 1


# Measured (block_q, block_k) table keyed by minimum sequence length: rows
# ascending by min_T; the last row whose min_T <= T and whose blocks divide
# the sequence lengths wins. Empty: the 128/128 default.
_TUNED_BLOCKS: list[tuple[int, int, int]] = []


def tuned_blocks(t_q: int, t_kv: int) -> tuple[int, int]:
    """Default (block_q, block_k) for the given sequence lengths: the
    measured table when a row fits, else 128/128."""
    bq, bk = 128, 128
    for min_t, q_, k_ in _TUNED_BLOCKS:
        if t_q >= min_t and t_q % q_ == 0 and t_kv % k_ == 0:
            bq, bk = q_, k_
    return bq, bk


def resolve_blocks(t_q: int, t_kv: int, dtype=None, causal: bool = False,
                   window: Optional[int] = None) -> tuple[int, int]:
    """Default-block resolution: the :data:`_TUNED_BLOCKS` table, then
    128/128. The autotune store (``flags().autotune``) is not ported yet, so
    the flag raises instead of being ignored."""
    from paddle_tpu_torch.core.config import flags

    if flags().autotune:
        raise NotImplementedError(
            "flags().autotune: the autotune store (paddle_tpu.tune) is not "
            "ported to paddle_tpu_torch yet"
        )
    return tuned_blocks(t_q, t_kv)


def _repeat_kv(q, x):
    """GQA: query head h reads kv head h // (H / H_kv)."""
    rep = q.shape[1] // x.shape[1]
    return x if rep == 1 else x.repeat_interleave(rep, dim=1)


def _mask_scores(s, causal: bool, kv_len, window, q_off: int, k_off: int):
    """Scores [B, H, T, T_kv] with the kernels' masks at GLOBAL positions
    ``q_off + i`` / ``k_off + j``: causal (top-left), sliding window and
    kv_len; masked scores take the finite NEG_INF."""
    q_pos = q_off + torch.arange(s.shape[-2], device=s.device)[:, None]
    k_pos = k_off + torch.arange(s.shape[-1], device=s.device)[None, :]
    if causal:
        live = q_pos >= k_pos
        if window is not None:  # sliding window: keep the last `window` keys
            live = live & (q_pos - k_pos < window)
        s = torch.where(live, s, NEG_INF)
    if kv_len is not None:
        s = torch.where(k_pos < kv_len.to(s.device)[:, None, None, None], s, NEG_INF)
    return s


def _reference_attention_with_lse(q, k, v, causal: bool, sm_scale: float,
                                  kv_len=None, window=None, q_off: int = 0,
                                  k_off: int = 0):
    """The plain version of the forward kernel: ``(out [B,H,T,d] in q's
    dtype, lse [B,H,T,1] f32)``. Port of ``_reference_attention`` (:593) —
    f32 products and accumulation, softmax probabilities rounded to q's
    dtype before the P V product — plus the logsumexp, masked by
    :func:`_mask_scores`. Rows with no live key differ from the kernel's
    (which depend on its tile skipping); both have lse < -1e8."""
    k, v = _repeat_kv(q, k), _repeat_kv(q, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    s = _mask_scores(s, causal, kv_len, window, q_off, k_off)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype), lse


def _reference_attention(q, k, v, causal: bool, sm_scale: float, kv_len=None, window=None):
    """Port of ``_reference_attention`` (:593): the output alone."""
    return _reference_attention_with_lse(q, k, v, causal, sm_scale, kv_len, window)[0]


def _bwd_probs(q, k, v, g, lse, delta, causal, sm_scale, kv_len, window, q_off, k_off):
    """What both backward kernels recompute (FlashAttention-2 eqs. 13-16,
    as the TPU kernels write them, all in f32): ``P = exp(S - lse)`` with
    ``S = (Q * sm_scale) K^T`` masked, and ``dS = P * (dO V^T - Delta)``,
    each [B, H, T, T_kv]. ``lse`` and ``delta`` are [B, H, T, 1] f32."""
    k, v = _repeat_kv(q, k), _repeat_kv(q, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * sm_scale, k.float())
    p = torch.exp(_mask_scores(s, causal, kv_len, window, q_off, k_off) - lse)
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    return p, p * (dp - delta)


def _flash_bwd_dkv_reference(q, k, v, g, lse, delta, causal: bool, sm_scale: float,
                             kv_len=None, window=None, q_off: int = 0, k_off: int = 0):
    """The plain version of the dK/dV kernel: ``dV = P^T dO`` and
    ``dK = dS^T (Q * sm_scale)``, summed over each kv head's query group,
    in k's and v's dtypes. Port of ``_flash_bwd_dkv_kernel`` (:362)."""
    p, ds = _bwd_probs(q, k, v, g, lse, delta, causal, sm_scale, kv_len, window, q_off, k_off)
    B, h_kv, t_kv, d = k.shape
    group = q.shape[1] // h_kv
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float() * sm_scale)
    dk = dk.reshape(B, h_kv, group, t_kv, d).sum(2)
    dv = dv.reshape(B, h_kv, group, t_kv, d).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_dq_reference(q, k, v, g, lse, delta, causal: bool, sm_scale: float,
                            kv_len=None, window=None, q_off: int = 0, k_off: int = 0):
    """The plain version of the dQ kernel: ``dQ = (dS K) * sm_scale`` in
    q's dtype. Port of ``_flash_bwd_dq_kernel`` (:434)."""
    _, ds = _bwd_probs(q, k, v, g, lse, delta, causal, sm_scale, kv_len, window, q_off, k_off)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _repeat_kv(q, k).float()) * sm_scale
    return dq.to(q.dtype)


def _check_cuda_inputs(q, k, v):
    """Raise on anything the CUDA kernels do not take: q [B, H, T, d] and
    k/v [B, H_kv, T_kv, d] on one card in one dtype (bf16 or f32), head dim
    32/64/128, each contiguous and 16-byte aligned."""
    B, H, T, d = q.shape
    enforce(q.device == k.device == v.device,
            f"flash_attention: q/k/v on different devices ({q.device}, {k.device}, {v.device})")
    enforce(q.dtype == k.dtype == v.dtype and q.dtype in (torch.bfloat16, torch.float32),
            f"flash_attention: q/k/v must share one dtype, bf16 or f32; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    enforce(k.dim() == 4 and k.shape == v.shape and k.shape[0] == B and k.shape[3] == d,
            f"flash_attention: k/v must be [B, H_kv, T_kv, d] matching q {tuple(q.shape)}; "
            f"got {tuple(k.shape)}, {tuple(v.shape)}")
    enforce(d in _HEAD_DIMS, f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        enforce(t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"flash_attention: {name} must be contiguous and 16-byte aligned")


def _check_bwd_inputs(q, k, v, g, lse, delta):
    """:func:`_check_cuda_inputs`, plus grad_out like q and lse/delta
    contiguous f32 [B, H, T, 1] on q's card."""
    _check_cuda_inputs(q, k, v)
    enforce(g.device == q.device and g.shape == q.shape and g.dtype == q.dtype
            and g.is_contiguous() and g.data_ptr() % 16 == 0,
            f"flash_attention: grad_out must be contiguous, 16-byte aligned and match q "
            f"({tuple(q.shape)}, {q.dtype}); got {tuple(g.shape)}, {g.dtype}")
    rows = tuple(q.shape[:3]) + (1,)
    for name, t in (("lse", lse), ("delta", delta)):
        enforce(t.device == q.device and t.dtype == torch.float32 and tuple(t.shape) == rows
                and t.is_contiguous(),
                f"flash_attention: {name} must be contiguous f32 {rows} on {q.device}")


def _kv_lens(kv_len, q):
    """kv_len as the kernels read it: [B] int32 on q's card, or None."""
    if kv_len is None:
        return None
    B = q.shape[0]
    enforce(tuple(kv_len.shape) == (B,),
            f"flash_attention: kv_len must be [B]={B}, got {tuple(kv_len.shape)}")
    return kv_len.to(device=q.device, dtype=torch.int32).clamp(min=0).contiguous()


def _tail_args(q, k, causal, window, q_off, k_off, sm_scale, lens):
    """The launchers' trailing arguments: kv_len pointer, shapes, masks,
    scale and PyTorch's current stream on q's card (read at the call, so a
    backward that autograd runs on another thread uses its own stream)."""
    B, H, T, d = q.shape
    return (
        lens.data_ptr() if lens is not None else None,
        B, H, k.shape[1], T, k.shape[2], d, int(q.dtype == torch.bfloat16), int(causal),
        int(window or 0), int(q_off), int(k_off), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float, kv_len, window,
                    q_off: int, k_off: int):
    """Check the inputs, allocate ``out``/``lse`` and launch the forward
    kernel on PyTorch's current stream."""
    _check_cuda_inputs(q, k, v)
    lens = _kv_lens(kv_len, q)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3] + (1,), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        FLASH_FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            *_tail_args(q, k, causal, window, q_off, k_off, sm_scale, lens),
        )
    return out, lse


def _live_pairs(T: int, T_kv: int, causal: bool, kv_len, window, q_off: int,
                k_off: int) -> int:
    """Live (query, key) pairs of one head summed over the batch: row i
    (global position q_off + i) attends keys j (global k_off + j) with
    j < T_kv, j < kv_len[b], and when causal k_off + j <= q_off + i and,
    with a window, q_off + i - (k_off + j) < window."""
    rel = q_off - k_off + np.arange(T, dtype=np.int64)  # row i's last causal key
    hi = np.minimum(T_kv, rel + 1) if causal else np.full(T, T_kv, np.int64)
    lo = np.maximum(0, rel - int(window) + 1) if (causal and window) else np.zeros(T, np.int64)
    if kv_len is None:
        return int(np.maximum(0, hi - lo).sum())
    lens = np.asarray(kv_len.detach().cpu().tolist(), np.int64).reshape(-1, 1)
    return int(np.maximum(0, np.minimum(hi[None, :], lens) - lo[None, :]).sum())


def _report_costs(name: str, q, k, causal, kv_len, window, q_off, k_off,
                  fwd_multiple: float, nbytes: int) -> None:
    """Report one kernel call to the active cost counters (no-op without
    one): ``fwd_multiple`` × the forward's 4·H·d·(live pairs over the
    batch) FLOPs, and ``nbytes``."""
    if not mfu._active_counters():
        return
    B, H, T, d = q.shape
    pairs = _live_pairs(T, k.shape[2], causal, kv_len, window, q_off, k_off)
    if kv_len is None:
        pairs *= B
    mfu.report_kernel(name, int(fwd_multiple * 4 * H * d * pairs), nbytes)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _flash_fwd(q, k, v, causal: bool, sm_scale: float, kv_len=None, window=None,
               q_off: int = 0, k_off: int = 0):
    """``(out [B,H,T,d], lse [B,H,T,1])``: the kernel for CUDA tensors, the
    plain version for CPU tensors, and for ``meta`` tensors the operator's
    shapes (no launch)."""
    enforce(q.dim() == 4, f"flash_attention: q must be [B, H, T, d], got {tuple(q.shape)}")
    enforce(q.shape[1] % k.shape[1] == 0,
            f"{q.shape[1]} query heads not divisible by {k.shape[1]} kv heads")
    if q.device.type == "meta":  # shapes only (analysis.lint_model): the operator's fake
        return flash_fwd_op(q, k, v, kv_len, causal, sm_scale, window, q_off, k_off)
    # reads q, k, v (and kv_len); writes out (like q) and the f32 lse
    _report_costs("flash_fwd", q, k, causal, kv_len, window, q_off, k_off, 1.0,
                  2 * _nbytes(q) + _nbytes(k, v, kv_len) + q[..., 0].numel() * 4)
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, sm_scale, kv_len, window, q_off, k_off)
    enforce(q.device.type == "cpu", f"flash_attention: unsupported device {q.device}")
    with mfu.paused():
        return _reference_attention_with_lse(q, k, v, causal, sm_scale, kv_len, window,
                                             q_off, k_off)


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal: bool, sm_scale: float,
                        kv_len=None, window=None, q_off: int = 0, k_off: int = 0):
    """Launch the dK/dV kernel; returns ``(dk, dv)`` like k and v."""
    _check_bwd_inputs(q, k, v, g, lse, delta)
    lens = _kv_lens(kv_len, q)  # held until the launch is enqueued
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        FLASH_BWD_DKV.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_tail_args(q, k, causal, window, q_off, k_off, sm_scale, lens),
        )
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal: bool, sm_scale: float,
                       kv_len=None, window=None, q_off: int = 0, k_off: int = 0):
    """Launch the dQ kernel; returns ``dq`` like q."""
    _check_bwd_inputs(q, k, v, g, lse, delta)
    lens = _kv_lens(kv_len, q)  # held until the launch is enqueued
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        FLASH_BWD_DQ.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(),
            *_tail_args(q, k, causal, window, q_off, k_off, sm_scale, lens),
        )
    return dq


def _flash_bwd(q, k, v, out, lse, g, causal: bool, sm_scale: float, kv_len=None,
               window=None, q_off: int = 0, k_off: int = 0):
    """Fused backward, port of ``_flash_bwd`` (:492-590): ``(dq, dk, dv)``,
    each in its primal's dtype (dk/dv at the kv head count under GQA). The
    two kernels for CUDA tensors, their plain versions for CPU tensors.
    ``Delta = rowsum(dO * O)`` in f32 (:515-518) is a torch op, with ``out``
    in its stored dtype."""
    enforce(out.shape == q.shape and g.shape == q.shape,
            f"flash_attention backward: out {tuple(out.shape)} and grad_out "
            f"{tuple(g.shape)} must match q {tuple(q.shape)}")
    g = g.contiguous()
    lse = lse.float().contiguous()
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, g, lse, delta, causal, sm_scale, kv_len, window, q_off, k_off)
    # each of the two kernels reads q, k, v, dO, lse, Delta (and kv_len);
    # together they write dq, dk, dv
    _report_costs("flash_bwd", q, k, causal, kv_len, window, q_off, k_off, 2.5,
                  2 * _nbytes(q, k, v, g, lse, delta, kv_len) + _nbytes(q, k, v))
    if q.device.type == "cuda":
        dk, dv = _flash_bwd_dkv_cuda(*args)
        return _flash_bwd_dq_cuda(*args), dk, dv
    enforce(q.device.type == "cpu", f"flash_attention: unsupported device {q.device}")
    with mfu.paused():
        dk, dv = _flash_bwd_dkv_reference(*args)
        return _flash_bwd_dq_reference(*args), dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: Optional[torch.Tensor], causal: bool, sm_scale: float,
                 window: Optional[int], q_off: int, k_off: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as a PyTorch operator, ``paddle_tpu_torch::flash_fwd``:
    ``(out, lse)`` as :func:`flash_attention_with_lse` gives them — the
    hand-written kernel for CUDA tensors, the plain version for CPU
    tensors. ``torch.export`` cannot trace a ``ctypes`` launch, so a traced
    call (``torch.compiler.is_compiling()``: ``torch.export``,
    ``torch.compile``) records this operator instead, and a saved program
    loaded in a process that imported ``paddle_tpu_torch`` calls the kernel
    through it (``io.save_inference_model``). Eager calls launch the kernel
    directly."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, sm_scale, kv_len, window, q_off, k_off)
    enforce(q.device.type == "cpu", f"flash_attention: unsupported device {q.device}")
    return _reference_attention_with_lse(q, k, v, causal, sm_scale, kv_len, window, q_off, k_off)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, kv_len, causal, sm_scale, window, q_off, k_off):
    """Shapes and dtypes only: ``out`` like q, ``lse`` f32 [B, H, T, 1]."""
    return torch.empty_like(q), q.new_empty(tuple(q.shape[:3]) + (1,), dtype=torch.float32)


class _FlashAttention(torch.autograd.Function):
    """The custom gradient of :func:`flash_attention` (the JAX package's
    ``_flash`` custom_vjp, :625-664): the forward kernel saves ``q, k, v,
    out, lse``; the backward runs the fused kernels under
    ``flags().flash_fused_bwd``, else autograd through the plain attention
    (recomputed; no activation was stored). ``kv_len`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, sm_scale, window):
        out, lse = _flash_fwd(q, k, v, causal, sm_scale, kv_len, window)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.causal, ctx.sm_scale, ctx.window = causal, sm_scale, window
        return out

    @staticmethod
    def backward(ctx, g):
        from paddle_tpu_torch.core.config import flags

        q, k, v, out, lse, kv_len = ctx.saved_tensors
        if flags().flash_fused_bwd:
            dq, dk, dv = _flash_bwd(q, k, v, out, lse, g, ctx.causal, ctx.sm_scale,
                                    kv_len, ctx.window)
        else:
            with torch.enable_grad():
                prim = [t.detach().requires_grad_() for t in (q, k, v)]
                o = _reference_attention(*prim, ctx.causal, ctx.sm_scale, kv_len, ctx.window)
                dq, dk, dv = torch.autograd.grad(o, prim, g)
        return dq, dk, dv, None, None, None, None


def _check_args(q, k, sm_scale, block_q, block_k, causal, window):
    if window is not None:
        enforce(causal, "flash_attention: window (sliding-window attention) "
                        "requires causal=True")
        enforce(window >= 1, f"window must be >= 1, got {window}")
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if block_q is None or block_k is None:
        # the JAX package resolves its TPU tiles here; the Hopper kernels
        # tile themselves, but the resolution order (and its refusal of the
        # unported autotune store) is kept
        resolve_blocks(q.shape[-2], k.shape[-2], q.dtype, causal, window)
    return float(sm_scale)


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    kv_len: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    q_off: int = 0,
    k_off: int = 0,
):
    """Forward-only fused attention returning ``(out, lse)`` with lse
    [B, H, T, 1] f32 — the building block for blockwise schedules (ring
    attention) that merge partials by lse. Not differentiable: the outputs
    carry no gradient on either device; such callers pair it with
    :func:`flash_attention_bwd_block` in their own autograd Function.
    ``q_off``/``k_off`` (ints) place Q and K/V at GLOBAL sequence positions:
    causal, ``window`` and ``kv_len`` masking act on global positions and
    dead kv tiles are skipped. Rows with no live key come back with
    lse ≈ NEG_INF."""
    sm_scale = _check_args(q, k, sm_scale, block_q, block_k, causal, window)
    if torch.compiler.is_compiling():
        return flash_fwd_op(q, k, v, kv_len, causal, sm_scale, window, q_off, k_off)
    with torch.no_grad():
        return _flash_fwd(q, k, v, causal, sm_scale, kv_len, window, q_off, k_off)


def flash_attention_bwd_block(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    kv_len: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    q_off: int = 0,
    k_off: int = 0,
):
    """One block-pair backward against GLOBAL residuals (port of :710-751):
    ``(dq, dk, dv)`` for this (Q, K/V) pair, where ``out``/``lse`` are the
    final attention output and logsumexp over the whole sequence, so the
    per-block contributions are independent and sum to the exact gradients.
    ``q_off``/``k_off``/``window``/``kv_len`` as in
    :func:`flash_attention_with_lse`; masked entries have
    p = exp(NEG_INF - lse) = 0, so dead blocks contribute exact zeros."""
    sm_scale = _check_args(q, k, sm_scale, block_q, block_k, causal, window)
    with torch.no_grad():
        return _flash_bwd(q, k, v, out, lse, g, causal, sm_scale, kv_len, window, q_off, k_off)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    kv_len: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention ``softmax(Q K^T * sm_scale) V``, differentiable in
    q, k and v (:class:`_FlashAttention`).

    q: [B, H, T, d]; k/v: [B, H_kv, T_kv, d] with H % H_kv == 0 (grouped-
    query attention when H_kv < H; dK/dV sum over each kv head's query
    group). ``kv_len`` ([B] int) masks key positions >= kv_len[b];
    ``window`` (with causal=True) keeps the last ``window`` keys. On CUDA:
    bf16 or f32 inputs, head dim 32, 64 or 128, contiguous; the output and
    the gradients have the inputs' dtypes."""
    sm_scale = _check_args(q, k, sm_scale, block_q, block_k, causal, window)
    if torch.compiler.is_compiling():  # an inference trace: the operator, no gradient
        return flash_fwd_op(q, k, v, kv_len, causal, sm_scale, window, 0, 0)[0]
    return _FlashAttention.apply(q, k, v, kv_len, causal, sm_scale, window)

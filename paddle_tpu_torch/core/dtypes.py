"""Dtype registry and mixed-precision policy.

The port of ``paddle_tpu.core.dtypes``: the same dtype names, resolved to
``torch.dtype``s, and the same policy — parameters f32, tensor-core operands
bf16 under ``flags().use_bf16_compute``, products accumulated in f32.

The f32 rule: f32 operands give f32 products, for matrix products and
convolutions alike, on the card as on the CPU. PyTorch's defaults let cuDNN
run f32 convolutions in TF32 (``torch.backends.cudnn.allow_tf32`` is True);
the port does not follow that process-wide switch: its f32 products on CUDA
run under :func:`ieee_f32`, in the forward and in the backward alike
(:func:`f32_matmul`, :func:`f32_bmm`, ``ops.nn.conv2d``), whatever the
flags say.
"""

from __future__ import annotations

import contextlib

import torch

# The port's integer width for indices and counts. The JAX package runs
# without x64, so its argmax/argmin/argsort/topk indices, ``shape``,
# ``arange``, ``cast(x, "int64")``, ``sampling_id``, ``rank_by_length`` and
# ``autoincreased_step_counter`` come back as int32 there; the port returns
# them as int64, PyTorch's native index width (what ``gather``,
# ``index_select`` and ``scatter`` take), so that no result is cast on its
# way into the next indexing op. The values are equal. Where the JAX package
# names int32 itself (decoded CRF tags, CTC and greedy/beam tokens, decoded
# lengths, ``mean_iou``'s counts, ``chunk_eval``'s counts), the port keeps
# int32.
INDEX_DTYPE = torch.int64

# Canonical dtype name -> torch dtype (the JAX package's name set).
_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def convert(dtype) -> torch.dtype:
    """Resolve a dtype name or ``torch.dtype`` to a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise KeyError(f"unknown dtype name {dtype!r}; known: {sorted(_DTYPES)}")
        return _DTYPES[dtype]
    raise TypeError(f"not a dtype: {dtype!r}")


def compute_dtype() -> torch.dtype:
    """The tensor-core operand dtype of the active policy."""
    from paddle_tpu_torch.core import config

    return torch.bfloat16 if config.flags().use_bf16_compute else torch.float32


def mxu_operands(*xs):
    """Cast floating operands to the active compute dtype before a matrix
    product: bf16 under ``flags().use_bf16_compute``, else unchanged. Call
    sites keep f32 accumulation and an f32 result (see :func:`f32_matmul`).
    ``None`` passes through."""
    cdt = compute_dtype()
    return tuple(
        x.to(cdt) if x is not None and x.is_floating_point() and x.dtype != cdt else x
        for x in xs
    )


@contextlib.contextmanager
def ieee_f32():
    """Run the enclosed f32 matrix products and cuDNN convolutions in full
    f32 (no TF32), restoring both of PyTorch's TF32 switches on exit. The
    switches are read when each kernel runs, so a backward that autograd
    runs later needs its own ``with`` (see :class:`_TensorCoreMatmul`)."""
    mm, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv


def _mm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A 2-D product with an f32 result on the card: bf16/fp16 operands on
    the tensor cores with f32 accumulation (``mm``'s ``out_dtype``), f32
    operands in full f32."""
    if a.dtype == torch.float32:
        with ieee_f32():
            return torch.mm(a, b)
    return torch.mm(a, b, out_dtype=torch.float32)


class _TensorCoreMatmul(torch.autograd.Function):
    """``a @ b`` on CUDA with an f32 result, operands as given. The backward
    rounds the f32 cotangent to the operands' dtype and runs both products
    (``dA = dC Bᵀ``, ``dB = Aᵀ dC``) the same way; the gradients come back
    in the operands' dtype, as autograd gives them through a cast."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32_out(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gc = g.to(a.dtype)
        da = _mm_f32_out(gc, b.t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = _mm_f32_out(a.t(), gc).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and an f32 result, on operands
    already rounded to the compute dtype — the JAX package's
    ``jnp.matmul(..., preferred_element_type=f32)``. A bf16-output matmul
    would also round the result to bf16, which the reference never does.

    On CUDA, 2-D operands go to :class:`_TensorCoreMatmul`: bf16 operands
    run on the tensor cores (forward and backward), f32 operands in full
    f32 (:func:`ieee_f32`). On the CPU the operands are cast to f32 and
    multiplied there (the CPU has no ``out_dtype`` kernel)."""
    if a.is_cuda:
        if a.dim() != 2 or b.dim() != 2 or a.dtype != b.dtype:
            raise ValueError(
                f"f32_matmul on CUDA takes two 2-D operands of one dtype, got "
                f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} {b.dtype}")
        return _TensorCoreMatmul.apply(a, b)
    return torch.matmul(a.float(), b.float())


def f32_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K] @ ``w`` [K, N] → [..., N] f32 (:func:`f32_matmul` on
    the flattened rows), the two operands first promoted to one dtype as
    ``jnp.matmul`` promotes them."""
    dt = torch.promote_types(x.dtype, w.dtype)
    out = f32_matmul(x.reshape(-1, x.shape[-1]).to(dt), w.to(dt))
    return out.reshape(*x.shape[:-1], w.shape[-1])


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.matmul(a, b, preferred_element_type=f32)`` for any ranks
    (vectors, matrices, broadcast batches): an f32 result with f32
    accumulation, the operands first promoted to one dtype. On the card a
    2-D right operand goes through :func:`f32_project`, batches through
    :func:`f32_bmm` (flattened after broadcasting); on the CPU the operands
    are cast to f32 and multiplied there."""
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    dt = torch.promote_types(a.dtype, b.dtype)
    if not dt.is_floating_point:
        dt = torch.float32
    a, b = a.to(dt), b.to(dt)
    vec_a, vec_b = a.dim() == 1, b.dim() == 1
    if vec_a:
        a = a[None]
    if vec_b:
        b = b[:, None]
    if b.dim() == 2:
        out = f32_project(a, b)
    else:
        lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
        b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
        out = f32_bmm(a3, b3).reshape(*lead, a.shape[-2], b.shape[-1])
    if vec_a:
        out = out.squeeze(-2)
    if vec_b:
        out = out.squeeze(-1)
    return out


def _bmm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`_mm_f32_out` over a batch: [N, M, K] × [N, K, P] → [N, M, P] f32."""
    if a.dtype == torch.float32:
        with ieee_f32():
            return torch.bmm(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


class _TensorCoreBmm(torch.autograd.Function):
    """:class:`_TensorCoreMatmul` over a batch of products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32_out(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gc = g.to(a.dtype)
        da = _bmm_f32_out(gc, b.transpose(1, 2)).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = _bmm_f32_out(a.transpose(1, 2), gc).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def f32_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched :func:`f32_matmul`: ``a`` [N, M, K] × ``b`` [N, K, P] → [N, M, P]
    f32 — the JAX package's batched ``einsum``/``matmul`` with
    ``preferred_element_type=f32``. On CUDA (:class:`_TensorCoreBmm`) bf16
    operands run on the tensor cores with f32 accumulation and f32 operands
    in full f32, forward and backward; on the CPU the operands are cast to
    f32 and multiplied there."""
    if a.is_cuda:
        if a.dim() != 3 or b.dim() != 3 or a.dtype != b.dtype:
            raise ValueError(
                f"f32_bmm on CUDA takes two 3-D operands of one dtype, got "
                f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} {b.dtype}")
        return _TensorCoreBmm.apply(a, b)
    return torch.matmul(a.float(), b.float())


# Log-space masking sentinel shared with the kernels — finite (unlike -inf)
# so 0 * NEG_INF stays 0 and fully masked rows stay finite.
NEG_INF = -1.0e9

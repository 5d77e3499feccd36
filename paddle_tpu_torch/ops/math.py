"""Math ops: elementwise, matmul, reductions, shape manipulation, random —
port of ``paddle_tpu/ops/math.py``, name for name (``__all__`` is the JAX
package's).

Reference: the dense math op families of ``paddle/fluid/operators/`` —
elementwise_{add,sub,mul,div,min,max,pow} (broadcast over a trailing axis
via the ``axis`` attr), activations (``activation_op.cc``), ``matmul_op``/
``mul_op``, reduce_* ops, ``top_k_op``, ``argsort_op``, gather/scatter/
concat/split/reshape/transpose/stack, clip, random ops. Each is a plain
PyTorch composition; the JAX package leaves them all to XLA, so no
hand-written kernel is owed.

Conventions kept from the JAX package:
- matrix products (:func:`matmul`) take their operands in the compute dtype
  (:func:`~paddle_tpu_torch.core.dtypes.mxu_operands`) and accumulate in
  f32 (:func:`~paddle_tpu_torch.core.dtypes.f32_product`): on the card bf16
  operands run on the tensor cores and f32 operands in full f32.
- ties: :func:`argsort` and :func:`topk` rank equal values by index, lower
  first (a stable sort), as ``jnp.argsort`` and ``lax.top_k`` do;
  :func:`argmax`/:func:`argmin` take the first extremum.
- kinks: :func:`maximum`, :func:`minimum`, :func:`clip` and the ops built
  on them (:func:`relu`, :func:`relu6`, :func:`hard_sigmoid`, ...) send
  half the gradient to each side of a tie, as ``jnp.maximum``/``jnp.clip``
  do (``torch.clamp`` would send all of it to x), and :func:`abs` has the
  gradient sign(x) with 1 at 0, as ``jnp.abs`` has (``torch.abs``: 0).
  With a Python bound they run torch's clamp forward and jnp's backward
  (an ``autograd.Function``), so they cost a clamp's launches. Other
  modules of the port use these for every ``jnp.maximum``,
  ``jnp.minimum``, ``jnp.clip`` and ``jnp.abs`` of a differentiated value,
  bar an eps floor (``maximum(norm, 1e-12)``), which no value ties: that
  stays a ``clamp_min``, whose gradient is then the same.
- indices out of range: :func:`gather` fills (``jnp.take``'s default),
  :func:`gather_nd` clamps (JAX's indexing) and :func:`scatter`/
  :func:`scatter_add` drop the update (``.at[]``); a negative index counts
  from the end first, once, and :func:`crop` wraps a negative offset and
  then clamps, as ``lax.dynamic_slice`` does.
- index-valued results are int64 here where JAX gives int32 (the policy of
  :data:`~paddle_tpu_torch.core.dtypes.INDEX_DTYPE`); integer sums and
  cumulative sums keep the input's width, as in JAX.
- creation ops (:func:`fill_constant`, :func:`arange`, the random ops, ...)
  put their tensor on ``device``: by default the device of the running
  ``Model.init``/``apply``, and outside one CUDA (``device="cpu"`` for the
  CPU).
- random ops draw from ``key``, a ``torch.Generator`` (the JAX package's
  PRNG key), by default the running apply's generator
  (:func:`paddle_tpu_torch.framework.next_rng`, which raises when the apply
  was given no ``rng``); the draws happen on the generator's device. The
  streams are the port's own: they agree with JAX's in distribution, not
  value by value.
"""

from __future__ import annotations

import builtins
import math as _math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import dtypes as _d

__all__ = [
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_min",
    "elementwise_max",
    "elementwise_pow",
    "relu",
    "relu6",
    "sigmoid",
    "tanh",
    "softplus",
    "softsign",
    "sqrt",
    "square",
    "exp",
    "log",
    "abs",
    "floor",
    "ceil",
    "round",
    "reciprocal",
    "gelu",
    "leaky_relu",
    "elu",
    "hard_sigmoid",
    "swish",
    "prelu_fn",
    "pow",
    "scale",
    "clip",
    "clip_by_norm",
    "matmul",
    "mul",
    "dot",
    "sum",
    "reduce_sum",
    "reduce_mean",
    "reduce_max",
    "reduce_min",
    "reduce_prod",
    "cumsum",
    "argmax",
    "argmin",
    "argsort",
    "topk",
    "cast",
    "concat",
    "split",
    "stack",
    "unstack",
    "reshape",
    "flatten",
    "squeeze",
    "unsqueeze",
    "transpose",
    "expand",
    "tile",
    "slice",
    "gather",
    "gather_nd",
    "scatter",
    "scatter_add",
    "pad",
    "crop",
    "reverse",
    "shape",
    "fill_constant",
    "zeros",
    "ones",
    "zeros_like",
    "ones_like",
    "arange",
    "linspace",
    "uniform_random",
    "gaussian_random",
    "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like",
    "truncated_gaussian_random",
    "sampling_id",
    "isfinite",
    "equal",
    "not_equal",
    "less_than",
    "less_equal",
    "greater_than",
    "greater_equal",
    "logical_and",
    "logical_or",
    "logical_not",
    "logical_xor",
    "where",
    "maximum",
    "minimum",
    "mean",
    "increment",
    "sign",
    "sin",
    "cos",
]


def _tensor(y, like: torch.Tensor) -> torch.Tensor:
    return y if isinstance(y, torch.Tensor) else torch.as_tensor(y, device=like.device)


def _broadcast_axis(x: torch.Tensor, y: torch.Tensor, axis: int) -> torch.Tensor:
    """Fluid elementwise broadcast semantics: y's shape matches a contiguous
    sub-range of x's dims starting at ``axis`` (reference
    ``operators/elementwise_op_function.h``). axis=-1 means trailing align
    (numpy broadcasting)."""
    if axis == -1 or x.dim() == y.dim():
        return y
    trailing = x.dim() - axis - y.dim()
    return y.reshape(tuple(y.shape) + (1,) * trailing)


def _elementwise(fn, name: str):
    def op(x, y, axis: int = -1):
        return fn(x, _broadcast_axis(x, _tensor(y, x), axis))

    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"Fluid ``{name}``: ``y`` broadcast onto ``x`` from dim ``axis`` (-1: numpy)."
    return op


elementwise_add = _elementwise(torch.add, "elementwise_add")
elementwise_sub = _elementwise(torch.sub, "elementwise_sub")
elementwise_mul = _elementwise(torch.mul, "elementwise_mul")
elementwise_div = _elementwise(torch.div, "elementwise_div")
elementwise_min = _elementwise(torch.minimum, "elementwise_min")
elementwise_max = _elementwise(torch.maximum, "elementwise_max")
elementwise_pow = _elementwise(torch.pow, "elementwise_pow")


# -- the kinks, as jax.numpy differentiates them ------------------------------
#
# A Python bound keeps torch's one-launch clamps in the forward; the
# backward below is jnp's. With no gradient wanted, the clamp alone runs.

_HALF = {}


def _step(d: torch.Tensor) -> torch.Tensor:
    """The derivative of ``jnp.maximum(d, 0)``: 0 below 0, 1/2 at 0, 1
    above (``torch.heaviside``; its 0-d 1/2 filled once a device and
    dtype). Not differentiated further (relu's second derivative is 0)."""
    half = _HALF.get((d.device, d.dtype))
    if half is None:
        half = _HALF[(d.device, d.dtype)] = torch.full((), 0.5, dtype=d.dtype, device=d.device)
    return torch.heaviside(d.detach(), half)


class _MaxMin(torch.autograd.Function):
    """``jnp.maximum(x, c)`` (``sense`` 1) or ``jnp.minimum(x, c)`` (-1) for
    a Python c: x takes the gradient g * step(sense * (x - c)), half of it
    at a tie."""

    @staticmethod
    def forward(ctx, x, c, sense):
        ctx.save_for_backward(x)
        ctx.c, ctx.sense = c, sense
        return torch.clamp_min(x, c) if sense > 0 else torch.clamp_max(x, c)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = x - ctx.c if ctx.c else x
        return g * _step(d if ctx.sense > 0 else -d), None, None


class _Clip(torch.autograd.Function):
    """``jnp.clip(x, lo, hi)`` for Python bounds, as ``minimum(maximum(x,
    lo), hi)`` differentiates: g * step(x - lo) * step(hi - x), half of it
    at either bound."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _step(x - ctx.lo if ctx.lo else x) * _step(ctx.hi - x), None, None


class _Abs(torch.autograd.Function):
    """``jnp.abs``: the gradient is g where x >= 0 (at 0 and -0.0 too)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _number(y) -> bool:
    return isinstance(y, (int, float)) and not isinstance(y, bool)


def _bound(x: torch.Tensor, y) -> torch.Tensor:
    """A bound as a tensor: a Python number as a 0-d tensor filled on x's
    device (JAX promotes an integer x beside a float to float)."""
    if isinstance(y, torch.Tensor):
        return y
    if isinstance(y, float) and not x.is_floating_point():
        return x.new_full((), y, dtype=torch.get_default_dtype())
    return x.new_full((), y)


def _grad_wanted(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def maximum(x, y):
    """``jnp.maximum``: at a tie each side takes half the gradient."""
    if _number(y) and x.is_floating_point():
        return _MaxMin.apply(x, y, 1) if _grad_wanted(x) else torch.clamp_min(x, y)
    return torch.maximum(x, _bound(x, y))


def minimum(x, y):
    """``jnp.minimum``: at a tie each side takes half the gradient."""
    if _number(y) and x.is_floating_point():
        return _MaxMin.apply(x, y, -1) if _grad_wanted(x) else torch.clamp_max(x, y)
    return torch.minimum(x, _bound(x, y))


def clip(x, min, max):  # noqa: A002
    """``jnp.clip``: ``minimum(maximum(x, min), max)``, so x at a bound
    takes half the gradient."""
    if _number(min) and _number(max) and x.is_floating_point():
        return _Clip.apply(x, min, max) if _grad_wanted(x) else torch.clamp(x, min, max)
    return minimum(maximum(x, min), max)


# -- activations (reference operators/activation_op.cc) ----------------------

def relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: gradient 0.5 at 0 (``jax.nn.relu``, and
    ``F.relu``, give 0 there)."""
    return maximum(x, 0.0)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return clip(x, 0.0, 6.0)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, exact for
    large x (``F.softplus`` turns linear above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1 + abs(x))


def sqrt(x):
    return torch.sqrt(x)


def square(x):
    return torch.square(x)


def exp(x):
    return torch.exp(x)


def log(x):
    return torch.log(x)


def abs(x):  # noqa: A001 - fluid op name
    """``jnp.abs``: the gradient is sign(x) with 1 at 0 (and at -0.0)."""
    return _Abs.apply(x) if x.is_floating_point() and _grad_wanted(x) else torch.abs(x)


def floor(x):
    return torch.floor(x)


def ceil(x):
    return torch.ceil(x)


def round(x):  # noqa: A001 - half to even, as jnp.round
    return torch.round(x)


def reciprocal(x):
    return 1.0 / x


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation by default."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x: torch.Tensor, alpha: float = 0.02) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * (torch.exp(x) - 1))


def hard_sigmoid(x, slope: float = 0.2, offset: float = 0.5):
    return clip(slope * x + offset, 0.0, 1.0)


def swish(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    return x * torch.sigmoid(beta * x)


def prelu_fn(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def pow(x, factor):  # noqa: A001
    return torch.pow(x, factor)


def scale(x, scale: float = 1.0, bias: float = 0.0, bias_after_scale: bool = True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def clip_by_norm(x, max_norm: float):
    norm = torch.sqrt(torch.sum(torch.square(x)))
    # an eps floor: never tied, so clamp_min's gradient is jnp.maximum's
    return x * minimum(max_norm / norm.clamp_min(1e-12), 1.0)


def sign(x):
    """``jnp.sign``: NaN stays NaN (``torch.sign`` gives 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x)) if x.is_floating_point() else torch.sign(x)


def sin(x):
    return torch.sin(x)


def cos(x):
    return torch.cos(x)


# -- matmul family ----------------------------------------------------------

def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False, alpha: float = 1.0):
    """Batched matmul (reference ``operators/matmul_op.cc`` semantics): the
    operands in the compute dtype, f32 accumulation, the result in x's dtype
    (or the two inputs' promoted dtype when they differ)."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = _d.f32_product(*_d.mxu_operands(x, y))
    if alpha != 1.0:
        out = out * alpha
    return out.to(x.dtype if x.dtype == y.dtype else torch.promote_types(x.dtype, y.dtype))


def mul(x, y, x_num_col_dims: int = 1, y_num_col_dims: int = 1):
    """Reference ``mul_op``: flatten x to 2-D at x_num_col_dims, y at
    y_num_col_dims, then matmul (operands as given, f32 accumulation);
    restore leading dims."""
    x_shape = tuple(x.shape)
    x2 = x.reshape(_math.prod(x_shape[:x_num_col_dims]), -1) if x.dim() > 2 else x
    y2 = y.reshape(-1, _math.prod(y.shape[y_num_col_dims:])) if y.dim() > 2 else y
    out = _d.f32_product(x2, y2).to(x.dtype)
    lead = x_shape[:x_num_col_dims]
    return out.reshape(lead + tuple(y.shape[y_num_col_dims:])) if x.dim() > 2 or y.dim() > 2 else out


def dot(x, y):
    return torch.sum(x * y, dim=-1, keepdim=True)


# -- reductions -------------------------------------------------------------

def _dims(x: torch.Tensor, dim) -> tuple:
    if dim is None:
        return tuple(range(x.dim()))
    return tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)


def _int_dtype(x: torch.Tensor):
    """The dtype JAX keeps for an integer sum/product (the input's)."""
    return x.dtype if not (x.is_floating_point() or x.dtype == torch.bool) else None


def reduce_sum(x, dim=None, keep_dim=False):
    return torch.sum(x, dim=_dims(x, dim), keepdim=keep_dim, dtype=_int_dtype(x))


def reduce_mean(x, dim=None, keep_dim=False):
    """Mean over ``dim`` (an int, a list of ints, or None for all)."""
    xf = x if x.is_floating_point() else x.float()
    return torch.mean(xf, dim=_dims(x, dim), keepdim=keep_dim)


def reduce_max(x, dim=None, keep_dim=False):
    return torch.amax(x, dim=_dims(x, dim), keepdim=keep_dim)


def reduce_min(x, dim=None, keep_dim=False):
    return torch.amin(x, dim=_dims(x, dim), keepdim=keep_dim)


def reduce_prod(x, dim=None, keep_dim=False):
    out = x
    for d in sorted((d % x.dim() for d in _dims(x, dim)), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keep_dim, dtype=_int_dtype(x))
    return out


def sum(xs):  # noqa: A001 - fluid sum op adds a list of tensors
    if isinstance(xs, (list, tuple)):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
    return torch.sum(xs, dtype=_int_dtype(xs))


def mean(x):
    return torch.mean(x if x.is_floating_point() else x.float())


def cumsum(x, axis: int = -1, exclusive: bool = False, reverse: bool = False):
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis, dtype=_int_dtype(x))
    if exclusive:
        out = out - x
    if reverse:
        out = torch.flip(out, (axis,))
    return out


def argmax(x, axis: int = -1):
    """Index of the first maximum (int64, see ``INDEX_DTYPE``)."""
    return torch.argmax(x, dim=axis)


def argmin(x, axis: int = -1):
    """Index of the first minimum (int64, see ``INDEX_DTYPE``)."""
    return torch.argmin(x, dim=axis)


def argsort(x, axis: int = -1, descending: bool = False):
    """Reference ``argsort_op``: returns (sorted, indices); a stable sort,
    so equal values keep their order. Descending sorts -x ascending, as
    the JAX package does, so a NaN comes last either way."""
    idx = torch.sort(-x if descending else x, dim=axis, stable=True).indices
    return torch.gather(x, axis, idx), idx


def topk(x, k: int):
    """Reference ``top_k_op``: (values, indices) of the k largest over the
    last axis, equal values ranked by the lower index (``lax.top_k``'s
    order, from a stable descending sort)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


# -- shape / data movement --------------------------------------------------

def cast(x, dtype):
    """``x`` in ``dtype`` (a name or a ``torch.dtype``); "int64" is int64
    here, int32 in the JAX package without x64."""
    return x.to(_d.convert(dtype))


def concat(xs: Sequence[torch.Tensor], axis: int = 0):
    return torch.cat(list(xs), dim=axis)


def split(x, num_or_sections: Union[int, Sequence[int]], dim: int = 0):
    """``num_or_sections`` equal parts (it must divide the dim, as in
    ``jnp.split``) or a list of section sizes."""
    if isinstance(num_or_sections, int):
        size = x.shape[dim]
        if size % num_or_sections:
            raise ValueError(f"split: dim {size} is not divisible into {num_or_sections} parts")
        return list(torch.split(x, size // num_or_sections, dim=dim))
    return list(torch.split(x, list(num_or_sections), dim=dim))


def stack(xs, axis: int = 0):
    return torch.stack(list(xs), dim=axis)


def unstack(x, axis: int = 0):
    return list(torch.unbind(x, dim=axis))


def reshape(x, shape: Sequence[int]):
    return torch.reshape(x, tuple(shape))


def flatten(x, axis: int = 1):
    return x.reshape(_math.prod(x.shape[:axis]), -1)


def squeeze(x, axes: Optional[Sequence[int]] = None):
    return torch.squeeze(x, dim=tuple(axes)) if axes else torch.squeeze(x)


def unsqueeze(x, axes: Sequence[int]):
    for a in sorted(axes):
        x = torch.unsqueeze(x, a)
    return x


def transpose(x, perm: Sequence[int]):
    return x.permute(*perm)


def expand(x, expand_times: Sequence[int]):
    return torch.tile(x, tuple(expand_times))


def tile(x, reps):
    return torch.tile(x, tuple(reps) if isinstance(reps, (list, tuple)) else (reps,))


def slice(x, axes: Sequence[int], starts: Sequence[int], ends: Sequence[int]):  # noqa: A001
    slicer = [builtins.slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        slicer[a] = builtins.slice(s, e)
    return x[tuple(slicer)]


def _wrap(index: torch.Tensor, n: int) -> torch.Tensor:
    """A negative index counted from the end (once, as JAX does)."""
    index = index.long()
    return torch.where(index < 0, index + n, index)


def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s fill for an index out of range: NaN, the least
    signed or the largest unsigned integer, True."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def gather(x, index, axis: int = 0):
    """``jnp.take(x, index, axis)``: the result's dims are x's before
    ``axis``, index's, then x's after. An index outside [-n, n) gives the
    fill of :func:`_fill_value` (``jnp.take``'s default mode) and no
    gradient."""
    index = _tensor(index, x).to(x.device)
    axis %= x.dim()
    n = x.shape[axis]
    flat = _wrap(index.reshape(-1), n)
    inside = (flat >= 0) & (flat < n)
    out = torch.index_select(x, axis, torch.where(inside, flat, 0))
    keep = inside.reshape((-1,) + (1,) * (x.dim() - axis - 1))
    out = torch.where(keep, out, out.new_full((), _fill_value(x.dtype)))
    return out.reshape(tuple(x.shape[:axis]) + tuple(index.shape) + tuple(x.shape[axis + 1:]))


def gather_nd(x, index):
    """``x[tuple(index[..., k] for k)]``: an index out of range is clamped
    into it, as JAX's indexing clamps, and (as JAX's scatter-add backward
    drops it) takes no gradient."""
    cols = [_wrap(c, x.shape[k]) for k, c in enumerate(index.long().unbind(-1))]
    inside = torch.stack([(c >= 0) & (c < x.shape[k]) for k, c in enumerate(cols)]).all(0)
    out = x[tuple(c.clamp(0, x.shape[k] - 1) for k, c in enumerate(cols))]
    keep = inside.reshape(tuple(inside.shape) + (1,) * (out.dim() - inside.dim()))
    return torch.where(keep, out, out.detach())


def _scatter(x, index, updates, accumulate: bool):
    """``x.at[index].set/add(updates)`` over x's rows: a row index outside
    [-n, n) drops its update (it lands on a spare row, cut off after)."""
    n = x.shape[0]
    index = _wrap(index, n)
    index = torch.where((index >= 0) & (index < n), index, n)
    spare = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return spare.index_put((index,), updates.to(x.dtype), accumulate=accumulate)[:n]


def scatter(x, index, updates):
    """Overwrite rows of x at index (reference ``scatter_op`` overwrite
    mode); out-of-range rows are dropped."""
    return _scatter(x, index, updates, False)


def scatter_add(x, index, updates):
    return _scatter(x, index, updates, True)


def pad(x, paddings: Sequence[int], pad_value: float = 0.0):
    """Reference ``pad_op``: paddings is [before0, after0, before1, after1, ...]."""
    flat = []
    for i in reversed(range(x.dim())):  # F.pad starts from the last dim
        flat += [int(paddings[2 * i]), int(paddings[2 * i + 1])]
    return F.pad(x, flat, value=pad_value)


def crop(x, offsets: Sequence[int], shape: Sequence[int]):
    """``lax.dynamic_slice``: a negative start counts from the end (once),
    then each start is clamped so the window fits."""
    out = x
    for a, (o, n) in enumerate(zip(offsets, shape)):
        start = int(o) + (x.shape[a] if int(o) < 0 else 0)
        start = builtins.min(builtins.max(start, 0), x.shape[a] - int(n))
        out = out.narrow(a, start, int(n))
    return out


def reverse(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(x, tuple(axes))


def shape(x):
    return torch.tensor(tuple(x.shape), dtype=_d.INDEX_DTYPE, device=x.device)


def increment(x, value: float = 1.0):
    return x + value


# -- creation ---------------------------------------------------------------

def _device(device) -> torch.device:
    """A creation op's device: the one given, else the running
    ``Model.init``/``apply``'s, else CUDA."""
    if device is not None:
        return torch.device(device)
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core.config import resolve_device

    return framework.current_device() if framework.in_frame() else resolve_device("cuda")


def fill_constant(shape: Sequence[int], dtype, value, device=None):
    return torch.full(tuple(shape), value, dtype=_d.convert(dtype), device=_device(device))


def zeros(shape, dtype="float32", device=None):
    return fill_constant(shape, dtype, 0, device)


def ones(shape, dtype="float32", device=None):
    return fill_constant(shape, dtype, 1, device)


def zeros_like(x):
    return torch.zeros_like(x)


def ones_like(x):
    return torch.ones_like(x)


def arange(start, end=None, step=1, dtype="int64", device=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_d.convert(dtype), device=_device(device))


def linspace(start, stop, num, dtype="float32", device=None):
    return torch.linspace(start, stop, num, dtype=_d.convert(dtype), device=_device(device))


# -- random (reference uniform_random_op / gaussian_random_op / ...) --------

def _generator(key) -> torch.Generator:
    if key is not None:
        return key
    from paddle_tpu_torch import framework

    return framework.next_rng()


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, key=None, device=None):  # noqa: A002
    """Uniform in [min, max) from ``key`` (a ``torch.Generator``)."""
    g = _generator(key)
    u = torch.rand(tuple(shape), generator=g, device=g.device)
    return (min + (max - min) * u).to(device=_device(device), dtype=_d.convert(dtype))


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, key=None, device=None):
    """Normal(mean, std) from ``key`` (a ``torch.Generator``)."""
    g = _generator(key)
    z = torch.randn(tuple(shape), generator=g, device=g.device)
    return (mean + std * z).to(device=_device(device), dtype=_d.convert(dtype))


def _batch_size_like_shape(input, shape, input_dim_idx, output_dim_idx):
    shp = [int(s) for s in shape]
    shp[output_dim_idx] = input.shape[input_dim_idx]
    return tuple(shp)


def uniform_random_batch_size_like(
    input, shape, dtype="float32", input_dim_idx=0, output_dim_idx=0,
    min=-1.0, max=1.0, key=None,  # noqa: A002
):
    """Uniform tensor whose ``output_dim_idx`` dim tracks ``input``'s
    ``input_dim_idx`` dim (reference ``uniform_random_batch_size_like_op.cc``),
    on input's device."""
    return uniform_random(
        _batch_size_like_shape(input, shape, input_dim_idx, output_dim_idx),
        dtype=dtype, min=min, max=max, key=key, device=input.device,
    )


def gaussian_random_batch_size_like(
    input, shape, dtype="float32", input_dim_idx=0, output_dim_idx=0,
    mean=0.0, std=1.0, key=None,
):
    """Gaussian tensor whose ``output_dim_idx`` dim tracks ``input``'s
    ``input_dim_idx`` dim (reference ``gaussian_random_batch_size_like_op.cc``),
    on input's device."""
    return gaussian_random(
        _batch_size_like_shape(input, shape, input_dim_idx, output_dim_idx),
        dtype=dtype, mean=mean, std=std, key=key, device=input.device,
    )


def truncated_gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, key=None, device=None):
    """``mean + std * z`` with z a standard normal truncated to [-2, 2]
    (``jax.random.truncated_normal``'s bounds), by the inverse CDF of a
    uniform draw between the bounds' CDF values."""
    g = _generator(key)
    lo, hi = (0.5 * (1.0 + _math.erf(b / _math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(tuple(shape), generator=g, device=g.device, dtype=torch.float64)
    # a draw, not differentiated: the clamp only guards erfinv's rounding
    z = (_math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
    return (mean + std * z).to(device=_device(device), dtype=_d.convert(dtype))


def sampling_id(probs, key=None):
    """Sample one category id per row from a probability matrix (reference
    ``sampling_id_op``); ids int64 (``INDEX_DTYPE``), on probs' device."""
    g = _generator(key)
    p = torch.clamp_min(probs.detach().float(), 1e-20).to(g.device)  # detached: no gradient
    return torch.multinomial(p, 1, generator=g)[:, 0].to(probs.device)


# -- comparison / logical ---------------------------------------------------

def isfinite(x):
    return torch.all(torch.isfinite(x))


def equal(x, y):
    return torch.eq(x, y)


def not_equal(x, y):
    return torch.ne(x, y)


def less_than(x, y):
    return torch.lt(x, y)


def less_equal(x, y):
    return torch.le(x, y)


def greater_than(x, y):
    return torch.gt(x, y)


def greater_equal(x, y):
    return torch.ge(x, y)


def logical_and(x, y):
    return torch.logical_and(x, _tensor(y, x))


def logical_or(x, y):
    return torch.logical_or(x, _tensor(y, x))


def logical_not(x):
    return torch.logical_not(x)


def logical_xor(x, y):
    return torch.logical_xor(x, _tensor(y, x))


def where(cond, x, y):
    return torch.where(cond, x, y)


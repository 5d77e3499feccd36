"""Every name of the port's ``ops.math`` against the JAX package's, on the CPU
in f32, as one parametrised registry (the style of
``tests/test_grad_blanket.py``): the same numpy-seeded inputs go through
``paddle_tpu.ops.math.<op>`` and ``paddle_tpu_torch.ops.math.<op>``.

Tolerances: forward outputs within 1e-5 relative L2 (a 1e-6 absolute floor
for outputs near 0); gradients of the differentiable ops (the JAX grad of
``sum(out * c)`` for a fixed cotangent ``c`` against autograd's) within 1e-4
relative L2. Integer and boolean outputs are equal, and index-valued ones
are int64 in the port where JAX gives int32 (``core.dtypes.INDEX_DTYPE``).
The kinkless inputs sit away from kinks and ties; the ``*_at_kink`` and
``*_ties`` cases sit exactly on them (0 for relu and abs, the bounds of
relu6, clip and hard_sigmoid, equal operands of maximum and minimum, a norm
equal to clip_by_norm's bound), where the gradient is the JAX package's: a
tie splits it 0.5/0.5 and |x| has gradient 1 at 0. Ties are also exercised
where the forward's order is the contract (argsort, topk). The edge cases
of §C.2 hold the JAX package's semantics: crop at a negative offset,
sign(NaN), argsort(descending=True) with NaNs, and indices out of range
(gather fills, gather_nd clamps, scatter and scatter_add drop). The random
ops are held by distribution: the port's streams are its own.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import math as jm
from paddle_tpu_torch.core.dtypes import INDEX_DTYPE
from paddle_tpu_torch.ops import math as tm

FWD_RTOL, FWD_FLOOR, GRAD_RTOL = 1e-5, 1e-6, 1e-4
R = np.random.RandomState(11)


def _kinkless(*shape, scale=1.0, offset=0.3):
    x = R.randn(*shape) * scale
    return (x + np.sign(x) * offset).astype(np.float32)


X = _kinkless(2, 3)
X3 = _kinkless(2, 3, 4)
XPOS = (np.abs(R.randn(2, 3)) + 0.5).astype(np.float32)
XPOS3 = (np.abs(R.randn(2, 3, 4)) + 0.5).astype(np.float32)
Y4 = _kinkless(4)
Y3 = _kinkless(3)
M34 = _kinkless(3, 4)
B234 = _kinkless(2, 3, 4)
B245 = _kinkless(2, 4, 5)
TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0], [0.0, 0.0, -1.0, 0.0, 5.0, 5.0]], np.float32)
IDX = np.array([2, 0, 2], np.int32)
IDX2 = np.array([[1, 0], [0, 2]], np.int32)
BOOL_A = np.array([[True, False, True], [False, False, True]])
BOOL_B = np.array([[True, True, False], [False, True, True]])
MIXED = np.array([[1.0, np.inf, -2.0], [np.nan, 0.5, 3.0]], np.float32)
KINK = np.array([[0.0, -0.0, 1.5, -2.0, 0.0, 6.0], [-1.0, 1.0, 0.0, 7.0, -3.0, 2.5]], np.float32)
KINK_B = np.array([[0.0, 1.0, 1.5, -2.0, -0.0, 5.0], [-1.0, 2.0, 0.0, 7.0, -3.0, -2.5]], np.float32)
NAN_ROW = np.array([[1.0, np.nan, 3.0, -1.0, np.nan, 3.0], [0.0, 2.0, np.nan, 2.0, -4.0, 0.0]],
                   np.float32)
GRID = np.arange(12, dtype=np.float32).reshape(4, 3)


def _dev(m):
    """The port's creation ops take device="cpu" here (their default is CUDA)."""
    return {"device": "cpu"} if m is tm else {}


# (id, fn(module, *args), args, grad argnums)
CASES = [
    ("elementwise_add", lambda m, x, y: m.elementwise_add(x, y), [X, X * 0.5], (0, 1)),
    ("elementwise_add_axis", lambda m, x, y: m.elementwise_add(x, y, axis=1), [X3, Y3], (0, 1)),
    ("elementwise_add_scalar", lambda m, x: m.elementwise_add(x, 2.5), [X], (0,)),
    ("elementwise_sub", lambda m, x, y: m.elementwise_sub(x, y), [X3, Y4], (0, 1)),
    ("elementwise_mul", lambda m, x, y: m.elementwise_mul(x, y, axis=0), [X3, X], (0, 1)),
    ("elementwise_div", lambda m, x, y: m.elementwise_div(x, y), [X, XPOS], (0, 1)),
    ("elementwise_min", lambda m, x, y: m.elementwise_min(x, y), [X, X[::-1].copy()], (0, 1)),
    ("elementwise_max", lambda m, x, y: m.elementwise_max(x, y), [X, X[::-1].copy()], (0, 1)),
    ("elementwise_pow", lambda m, x, y: m.elementwise_pow(x, y), [XPOS, X * 0.5], (0, 1)),
    ("relu", lambda m, x: m.relu(x), [X], (0,)),
    ("relu6", lambda m, x: m.relu6(x), [X * 4], (0,)),
    ("sigmoid", lambda m, x: m.sigmoid(x), [X], (0,)),
    ("tanh", lambda m, x: m.tanh(x), [X], (0,)),
    ("softplus", lambda m, x: m.softplus(x), [X * 10], (0,)),
    ("softsign", lambda m, x: m.softsign(x), [X], (0,)),
    ("sqrt", lambda m, x: m.sqrt(x), [XPOS], (0,)),
    ("square", lambda m, x: m.square(x), [X], (0,)),
    ("exp", lambda m, x: m.exp(x), [X], (0,)),
    ("log", lambda m, x: m.log(x), [XPOS], (0,)),
    ("abs", lambda m, x: m.abs(x), [X], (0,)),
    ("floor", lambda m, x: m.floor(x), [X * 3], (0,)),
    ("ceil", lambda m, x: m.ceil(x), [X * 3], (0,)),
    ("round", lambda m, x: m.round(x), [np.array([0.5, 1.5, 2.5, -0.5, -1.7, 2.2], np.float32)], (0,)),
    ("reciprocal", lambda m, x: m.reciprocal(x), [XPOS], (0,)),
    ("gelu", lambda m, x: m.gelu(x), [X], (0,)),
    ("gelu_exact", lambda m, x: m.gelu(x, approximate=False), [X], (0,)),
    ("leaky_relu", lambda m, x: m.leaky_relu(x, 0.1), [X], (0,)),
    ("elu", lambda m, x: m.elu(x, 0.7), [X], (0,)),
    ("hard_sigmoid", lambda m, x: m.hard_sigmoid(x), [X], (0,)),
    ("swish", lambda m, x: m.swish(x, 1.5), [X], (0,)),
    ("prelu_fn", lambda m, x, a: m.prelu_fn(x, a), [X, np.float32([0.2, 0.3, 0.4])], (0, 1)),
    ("pow", lambda m, x: m.pow(x, 3.0), [X], (0,)),
    ("scale", lambda m, x: m.scale(x, 2.5, bias=1.0), [X], (0,)),
    ("scale_bias_first", lambda m, x: m.scale(x, 2.5, 1.0, bias_after_scale=False), [X], (0,)),
    ("clip", lambda m, x: m.clip(x, -1.0, 1.0), [X * 0.7], (0,)),
    ("clip_by_norm", lambda m, x: m.clip_by_norm(x, 0.8), [X], (0,)),
    ("clip_by_norm_inside", lambda m, x: m.clip_by_norm(x, 100.0), [X], (0,)),
    ("matmul", lambda m, x, y: m.matmul(x, y), [X, M34], (0, 1)),
    ("matmul_transposed", lambda m, x, y: m.matmul(x, y, True, True, alpha=0.5),
     [M34.T.copy(), B245[0].T.copy()], (0, 1)),
    ("matmul_batched", lambda m, x, y: m.matmul(x, y), [B234, B245], (0, 1)),
    ("matmul_broadcast", lambda m, x, y: m.matmul(x, y), [B234, _kinkless(4, 2)], (0, 1)),
    ("matmul_vector", lambda m, x, y: m.matmul(x, y), [M34, Y4], (0, 1)),
    ("mul", lambda m, x, y: m.mul(x, y), [X, M34], (0, 1)),
    ("mul_flatten", lambda m, x, y: m.mul(x, y, 1, 2), [B234, _kinkless(3, 4, 5)], (0, 1)),
    ("dot", lambda m, x, y: m.dot(x, y), [X, X * 0.3], (0, 1)),
    ("sum_list", lambda m, x, y: m.sum([x, y, x]), [X, X * 0.5], (0, 1)),
    ("sum_tensor", lambda m, x: m.sum(x), [X3], (0,)),
    ("sum_int", lambda m, x: m.sum(x), [IDX], ()),
    ("reduce_sum", lambda m, x: m.reduce_sum(x), [X3], (0,)),
    ("reduce_sum_dims", lambda m, x: m.reduce_sum(x, [0, 2], keep_dim=True), [X3], (0,)),
    ("reduce_sum_int", lambda m, x: m.reduce_sum(x, 0), [IDX2], ()),
    ("reduce_mean", lambda m, x: m.reduce_mean(x, 1), [X3], (0,)),
    ("reduce_max", lambda m, x: m.reduce_max(x, -1), [X3], (0,)),
    ("reduce_min", lambda m, x: m.reduce_min(x, [1, 2], keep_dim=True), [X3], (0,)),
    ("reduce_prod", lambda m, x: m.reduce_prod(x, [0, 2]), [X3], (0,)),
    ("reduce_prod_all", lambda m, x: m.reduce_prod(x), [X * 0.9], (0,)),
    ("cumsum", lambda m, x: m.cumsum(x, 1), [X3], (0,)),
    ("cumsum_exclusive_reverse", lambda m, x: m.cumsum(x, -1, exclusive=True, reverse=True),
     [X3], (0,)),
    ("cumsum_int", lambda m, x: m.cumsum(x), [IDX], ()),
    ("argmax", lambda m, x: m.argmax(x), [TIES], ()),
    ("argmin", lambda m, x: m.argmin(x, 0), [TIES], ()),
    ("argsort", lambda m, x: m.argsort(x), [TIES], ()),
    ("argsort_descending", lambda m, x: m.argsort(x, -1, descending=True), [TIES], ()),
    ("argsort_axis0", lambda m, x: m.argsort(x, 0), [TIES], ()),
    ("argsort_values_grad", lambda m, x: m.argsort(x, descending=True)[0], [X3], (0,)),
    ("topk", lambda m, x: m.topk(x, 3), [TIES], ()),
    ("topk_values_grad", lambda m, x: m.topk(x, 2)[0], [X3], (0,)),
    ("cast", lambda m, x: m.cast(x, "int32"), [X * 3], ()),
    ("cast_grad", lambda m, x: m.cast(x, "float32") * 2.0, [X], (0,)),
    ("cast_bool", lambda m, x: m.cast(x, "bool"), [np.array([0.0, 1.0, -2.0], np.float32)], ()),
    ("concat", lambda m, x, y: m.concat([x, y, x], axis=1), [X3, X3 * 2], (0, 1)),
    ("split", lambda m, x: m.split(x, 2, dim=2), [X3], (0,)),
    ("split_sections", lambda m, x: m.split(x, [1, 3], dim=-1), [X3], (0,)),
    ("stack", lambda m, x, y: m.stack([x, y], axis=1), [X, X * 3], (0, 1)),
    ("unstack", lambda m, x: m.unstack(x, 1), [X3], (0,)),
    ("reshape", lambda m, x: m.reshape(x, [4, -1]), [X3], (0,)),
    ("flatten", lambda m, x: m.flatten(x, 2), [X3], (0,)),
    ("squeeze", lambda m, x: m.squeeze(x, [1]), [X3[:, :1]], (0,)),
    ("squeeze_all", lambda m, x: m.squeeze(x), [X3[:1, :, :1]], (0,)),
    ("unsqueeze", lambda m, x: m.unsqueeze(x, [0, 3]), [X], (0,)),
    ("transpose", lambda m, x: m.transpose(x, [2, 0, 1]), [X3], (0,)),
    ("expand", lambda m, x: m.expand(x, [2, 1, 3]), [X3], (0,)),
    ("tile", lambda m, x: m.tile(x, (2, 1)), [X], (0,)),
    ("tile_int", lambda m, x: m.tile(x, 3), [Y3], (0,)),
    ("slice", lambda m, x: m.slice(x, [1, 2], [1, -3], [3, 100]), [X3], (0,)),
    ("gather", lambda m, x, i: m.gather(x, i, axis=1), [X3, IDX], (0,)),
    ("gather_2d_index", lambda m, x, i: m.gather(x, i), [M34, IDX2], (0,)),
    ("gather_nd", lambda m, x, i: m.gather_nd(x, i), [X3, IDX2], (0,)),
    ("scatter", lambda m, x, i, u: m.scatter(x, i, u),
     [M34, np.array([2, 0], np.int32), _kinkless(2, 4)], (0, 2)),
    ("scatter_add", lambda m, x, i, u: m.scatter_add(x, i, u),
     [M34, np.array([2, 0, 2], np.int32), _kinkless(3, 4)], (0, 2)),
    ("pad", lambda m, x: m.pad(x, [0, 1, 2, 0, 1, 1], pad_value=-1.5), [X3], (0,)),
    ("crop", lambda m, x: m.crop(x, [0, 1, 1], [2, 2, 3]), [X3], (0,)),
    ("crop_clamped", lambda m, x: m.crop(x, [1, 2, 3], [2, 2, 3]), [X3], (0,)),
    ("reverse", lambda m, x: m.reverse(x, [0, 2]), [X3], (0,)),
    ("reverse_int_axis", lambda m, x: m.reverse(x, 1), [X3], (0,)),
    ("shape", lambda m, x: m.shape(x), [X3], ()),
    ("fill_constant", lambda m: m.fill_constant([2, 3], "float32", 1.5, **_dev(m)), [], ()),
    ("fill_constant_int", lambda m: m.fill_constant([4], "int32", 7, **_dev(m)), [], ()),
    ("zeros", lambda m: m.zeros([3, 2], **_dev(m)), [], ()),
    ("ones", lambda m: m.ones([2], "float32", **_dev(m)), [], ()),
    ("zeros_like", lambda m, x: m.zeros_like(x), [X3], ()),
    ("ones_like", lambda m, x: m.ones_like(x), [IDX], ()),
    ("arange", lambda m: m.arange(7, **_dev(m)), [], ()),
    ("arange_float", lambda m: m.arange(1, 4, 0.5, dtype="float32", **_dev(m)), [], ()),
    ("linspace", lambda m: m.linspace(-1.0, 2.0, 7, **_dev(m)), [], ()),
    ("isfinite", lambda m, x: m.isfinite(x), [MIXED], ()),
    ("isfinite_all", lambda m, x: m.isfinite(x), [X], ()),
    ("equal", lambda m, x, y: m.equal(x, y), [TIES, TIES[:, ::-1].copy()], ()),
    ("not_equal", lambda m, x, y: m.not_equal(x, y), [TIES, TIES[:, ::-1].copy()], ()),
    ("less_than", lambda m, x, y: m.less_than(x, y), [TIES, TIES[:, ::-1].copy()], ()),
    ("less_equal", lambda m, x, y: m.less_equal(x, y), [TIES, TIES[:, ::-1].copy()], ()),
    ("greater_than", lambda m, x, y: m.greater_than(x, y), [TIES, TIES[:, ::-1].copy()], ()),
    ("greater_equal", lambda m, x, y: m.greater_equal(x, y), [TIES, TIES[:, ::-1].copy()], ()),
    ("logical_and", lambda m, a, b: m.logical_and(a, b), [BOOL_A, BOOL_B], ()),
    ("logical_or", lambda m, a, b: m.logical_or(a, b), [BOOL_A, BOOL_B], ()),
    ("logical_not", lambda m, a: m.logical_not(a), [BOOL_A], ()),
    ("logical_xor", lambda m, a, b: m.logical_xor(a, b), [BOOL_A, BOOL_B], ()),
    ("where", lambda m, c, x, y: m.where(c, x, y), [BOOL_A, X, X * -2], (1, 2)),
    ("maximum", lambda m, x, y: m.maximum(x, y), [X, X[::-1].copy()], (0, 1)),
    ("maximum_scalar", lambda m, x: m.maximum(x, 0.5), [X], (0,)),
    ("minimum", lambda m, x, y: m.minimum(x, y), [X, X[::-1].copy()], (0, 1)),
    ("mean", lambda m, x: m.mean(x), [X3], (0,)),
    ("increment", lambda m, x: m.increment(x, 2.0), [X], (0,)),
    ("sign", lambda m, x: m.sign(x), [np.array([-2.0, 0.0, 3.0], np.float32)], ()),
    ("sin", lambda m, x: m.sin(x), [X], (0,)),
    ("cos", lambda m, x: m.cos(x), [X], (0,)),
    # exactly on the kinks and ties (§C.1)
    ("relu_at_kink", lambda m, x: m.relu(x), [KINK], (0,)),
    ("relu6_at_kink", lambda m, x: m.relu6(x), [KINK], (0,)),
    ("clip_at_kink", lambda m, x: m.clip(x, -1.0, 1.0), [KINK], (0,)),
    ("hard_sigmoid_at_kink", lambda m, x: m.hard_sigmoid(x), [KINK], (0,)),
    ("abs_at_kink", lambda m, x: m.abs(x), [KINK], (0,)),
    ("softsign_at_kink", lambda m, x: m.softsign(x), [KINK], (0,)),
    ("clip_by_norm_at_kink", lambda m, x: m.clip_by_norm(x, 5.0), [np.float32([[3.0, 0.0], [0.0, 4.0]])],
     (0,)),
    ("maximum_ties", lambda m, x, y: m.maximum(x, y), [KINK, KINK_B], (0, 1)),
    ("maximum_scalar_ties", lambda m, x: m.maximum(x, 1.5), [KINK], (0,)),
    ("minimum_ties", lambda m, x, y: m.minimum(x, y), [KINK, KINK_B], (0, 1)),
    ("elementwise_max_ties", lambda m, x, y: m.elementwise_max(x, y), [KINK, KINK_B], (0, 1)),
    ("elementwise_min_ties", lambda m, x, y: m.elementwise_min(x, y), [KINK, KINK_B], (0, 1)),
    # the edge semantics (§C.2)
    ("crop_negative_offset", lambda m, x: m.crop(x, [3, -1], [2, 2]), [GRID], (0,)),
    ("crop_negative_offset_3d", lambda m, x: m.crop(x, [-1, -2, -7], [1, 2, 3]), [X3], (0,)),
    ("sign_nan", lambda m, x: m.sign(x), [NAN_ROW], ()),
    ("argsort_descending_nan", lambda m, x: m.argsort(x, descending=True), [NAN_ROW], ()),
    ("argsort_nan", lambda m, x: m.argsort(x), [NAN_ROW], ()),
    ("gather_out_of_range_fills", lambda m, x, i: m.gather(x, i), [GRID, np.array([0, -1, 3, 4, -5],
                                                                                  np.int32)], (0,)),
    ("gather_out_of_range_fills_axis1", lambda m, x, i: m.gather(x, i, axis=1),
     [X3, np.array([[1, -4], [3, -3]], np.int32)], (0,)),
    ("gather_out_of_range_fills_int", lambda m, x, i: m.gather(x, i),
     [np.arange(12, dtype=np.int32).reshape(4, 3), np.array([4, -5, 1], np.int32)], ()),
    ("gather_nd_out_of_range_clamps", lambda m, x, i: m.gather_nd(x, i),
     [GRID, np.array([[0, 1], [-1, 2], [5, 7], [-6, 0]], np.int32)], (0,)),
    ("scatter_out_of_range_drops", lambda m, x, i, u: m.scatter(x, i, u),
     [M34, np.array([1, -1, 5, -6], np.int32), _kinkless(4, 4)], (0, 2)),
    ("scatter_add_out_of_range_drops", lambda m, x, i, u: m.scatter_add(x, i, u),
     [M34, np.array([0, -1, 3, 0, -4], np.int32), _kinkless(5, 4)], (0, 2)),
]

# index-valued outputs: int64 in the port, int32 in JAX (INDEX_DTYPE)
INDEX_OUTPUTS = {"argmax", "argmin", "argsort", "argsort_descending", "argsort_axis0", "topk",
                 "shape", "arange", "argsort_descending_nan", "argsort_nan"}


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _to_np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(name, got, want, rtol, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=name)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=name)  # NaN, ±inf alike
    err = np.linalg.norm(np.where(finite, got - want, 0.0))
    assert err <= rtol * max(np.linalg.norm(np.where(finite, want, 0.0)), floor), (name, err)


def _cotangents(outs, seed):
    r = np.random.RandomState(seed)
    return [np.asarray(r.randn(*np.shape(o)), np.float32) for o in outs]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax(case):
    name, fn, args, _ = case
    want = _flat(fn(jm, *(jnp.asarray(a) for a in args)))
    got = _flat(fn(tm, *(torch.from_numpy(np.array(a)) for a in args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g_np = _to_np(g)
        if w.dtype.kind in "biu":
            if name in INDEX_OUTPUTS and w.dtype.kind in "iu":
                assert g.dtype == INDEX_DTYPE, (name, g.dtype)
            else:
                assert str(g.dtype).replace("torch.", "") == w.dtype.name, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g_np, w, err_msg=name)
        else:
            assert g.dtype == torch.float32, (name, g.dtype)
            _close(name, g_np, w, FWD_RTOL, FWD_FLOOR)


GRAD_CASES = [c for c in CASES if c[3]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradient_matches_jax(case):
    name, fn, args, argnums = case
    outs = _flat(fn(jm, *(jnp.asarray(a) for a in args)))
    cts = _cotangents(outs, 3)

    def j_loss(*xs):
        return sum(jnp.sum(o * c) for o, c in zip(_flat(fn(jm, *xs)), cts))

    want = jax.grad(j_loss, argnums=argnums)(*(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(np.array(a)) for a in args]
    for i in argnums:
        ts[i].requires_grad_(True)
    loss = sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(_flat(fn(tm, *ts)), cts))
    got = torch.autograd.grad(loss, [ts[i] for i in argnums])
    for i, g, w in zip(argnums, got, want):
        _close(f"{name} d/darg{i}", g.numpy(), w, GRAD_RTOL, 1e-8)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_abs_at_kink_keeps_the_sign_of_zero(grad):
    """``abs(-0.0)`` is +0.0 in both packages (a value compare cannot tell),
    whether or not a gradient is wanted."""
    want = np.signbit(np.asarray(jm.abs(jnp.asarray(KINK))))
    got = tm.abs(torch.from_numpy(KINK.copy()).requires_grad_(grad))
    np.testing.assert_array_equal(np.signbit(got.detach().numpy()), want)
    assert not want.any()


def test_all_equals_the_jax_package_and_every_name_is_held():
    assert tm.__all__ == jm.__all__
    covered = {c[0].split("_grad")[0] for c in CASES} | {c[0] for c in CASES}
    held = {n for n in tm.__all__ if any(c == n or c.startswith(n + "_") for c in covered)}
    random_ops = {"uniform_random", "gaussian_random", "uniform_random_batch_size_like",
                  "gaussian_random_batch_size_like", "truncated_gaussian_random", "sampling_id"}
    assert set(tm.__all__) - held == random_ops


# ------------------------------------------------------------ random ops

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_uniform_random_distribution_and_key():
    a = tm.uniform_random([20000], min=-2.0, max=3.0, key=_gen(1), device="cpu")
    b = tm.uniform_random([20000], min=-2.0, max=3.0, key=_gen(1), device="cpu")
    j = np.asarray(jm.uniform_random([20000], min=-2.0, max=3.0, key=jax.random.PRNGKey(1)))
    assert a.dtype == torch.float32 and tuple(a.shape) == j.shape
    assert torch.equal(a, b)  # one key, one stream
    assert float(a.min()) >= -2.0 and float(a.max()) < 3.0
    # mean 0.5, std 5/sqrt(12) = 1.443: both within 4 sigma of the mean's spread
    for s in (a.numpy(), j):
        assert abs(s.mean() - 0.5) < 4 * 1.443 / np.sqrt(s.size)
        assert abs(s.std() - 1.443) < 0.03


def test_gaussian_random_and_batch_size_like():
    g = tm.gaussian_random([30000], mean=1.0, std=2.0, key=_gen(2), device="cpu").numpy()
    assert abs(g.mean() - 1.0) < 4 * 2.0 / np.sqrt(g.size) and abs(g.std() - 2.0) < 0.05
    x = torch.zeros(5, 3)
    u = tm.uniform_random_batch_size_like(x, [-1, 4], key=_gen(3))
    n = tm.gaussian_random_batch_size_like(x, [7, -1], input_dim_idx=1, output_dim_idx=1,
                                           key=_gen(3))
    ju = jm.uniform_random_batch_size_like(jnp.zeros((5, 3)), [-1, 4], key=jax.random.PRNGKey(3))
    assert tuple(u.shape) == ju.shape == (5, 4) and tuple(n.shape) == (7, 3)
    assert u.device == x.device and float(u.abs().max()) <= 1.0


def test_truncated_gaussian_random_bounds_and_moments():
    t = tm.truncated_gaussian_random([40000], mean=0.5, std=3.0, key=_gen(4), device="cpu").numpy()
    j = np.asarray(jm.truncated_gaussian_random([40000], mean=0.5, std=3.0,
                                                key=jax.random.PRNGKey(4)))
    for s in (t, j):
        assert s.min() >= 0.5 - 6.0 - 1e-5 and s.max() <= 0.5 + 6.0 + 1e-5
        # a standard normal truncated to [-2, 2] has std 0.8796
        assert abs(s.std() - 3.0 * 0.8796) < 0.05 and abs(s.mean() - 0.5) < 0.06


def test_sampling_id_follows_the_probabilities():
    probs = np.array([[0.1, 0.6, 0.3], [0.0, 0.0, 1.0]], np.float32)
    ids = torch.stack([tm.sampling_id(torch.from_numpy(probs), key=g)
                       for g in [_gen(5)] * 4000])
    assert ids.dtype == INDEX_DTYPE and tuple(ids.shape) == (4000, 2)
    freq = np.bincount(ids[:, 0].numpy(), minlength=3) / 4000.0
    np.testing.assert_allclose(freq, probs[0], atol=0.03)
    assert bool((ids[:, 1] == 2).all())
    jids = np.asarray(jm.sampling_id(jnp.asarray(probs), key=jax.random.PRNGKey(5)))
    assert jids.shape == (2,) and jids[1] == 2


def test_random_ops_draw_from_the_apply_generator():
    import paddle_tpu_torch as pt

    def net(x):
        return pt.layers.fc(x, 3, bias_attr=False) * 0.0 + pt.ops.math.uniform_random([1, 3])

    model = pt.build(net)
    x = torch.zeros(1, 2)
    v = model.init(0, x, device="cpu")
    a, _ = model.apply(v, x, rng=torch.Generator().manual_seed(9))
    b, _ = model.apply(v, x, rng=torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and float(a.abs().max()) <= 1.0 and a.device.type == "cpu"
    with pytest.raises(Exception, match="rng"):
        model.apply(v, x)

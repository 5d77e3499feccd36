"""The port's layer catalog against the JAX package's, on the CPU in f32.

- ``layers.__all__``, ``nets.__all__``, ``ops.math.__all__`` and
  ``ops.__all__`` are the JAX package's (in the same order), every name
  resolves, and ``ops`` holds the flat namespace (``ops.relu is
  ops.math.relu``).
- Each parameterised layer makes the JAX package's parameter (and state)
  names and shapes at ``init``, and with the JAX init's weights carried
  across (``convert.variables_from_jax``) gives the JAX package's outputs
  within 1e-5 relative L2 (recurrent layers 1e-4), and new state alike.
- The tensor helpers, control-flow adapters, metrics and reader layers
  behave as the JAX package's; ``open_recordio_file``/``open_files`` raise
  ``NotImplementedError`` (ROADMAP §A item 8).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import config as tcfg

RTOL, RNN_RTOL = 1e-5, 1e-4

def test_export_lists_equal_the_jax_package():
    assert tpt.layers.__all__ == jpt.layers.__all__
    assert tpt.nets.__all__ == jpt.nets.__all__
    assert tpt.ops.math.__all__ == jpt.ops.math.__all__
    missing = [n for n in tpt.layers.__all__ + tpt.nets.__all__ if
               not hasattr(tpt.layers, n) and not hasattr(tpt.nets, n)]
    assert not missing


def test_ops_namespace_equals_the_jax_package():
    assert tpt.ops.__all__ == jpt.ops.__all__
    assert tpt.ops.relu is tpt.ops.math.relu
    assert tpt.ops.ssd_loss is tpt.ops.detection.ssd_loss
    assert tpt.ops.fake_quantize_abs_max is tpt.ops.quant.fake_quantize_abs_max
    # a name of several modules is the last one's, in both packages
    mods = ("math", "nn", "control_flow", "losses", "detection", "quant")
    for n in jpt.ops.__all__:
        home = [m for m in mods if n in getattr(jpt.ops, m).__all__]
        if not home:  # a submodule
            assert getattr(tpt.ops, n).__name__ == f"paddle_tpu_torch.ops.{n}"
            continue
        assert getattr(jpt.ops, n) is getattr(getattr(jpt.ops, home[-1]), n), n
        assert getattr(tpt.ops, n) is getattr(getattr(tpt.ops, home[-1]), n), n


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ids(seed, *shape, high=9):
    return np.random.RandomState(seed).randint(0, high, size=shape).astype(np.int32)


LENS = np.array([5, 2, 4], np.int32)
IMG = _x(1, 2, 6, 6, 3)

# (id, fn(package, *args), args, is_train, rtol)
LAYERS = [
    ("fc", lambda p, x: p.layers.fc(x, 5, num_flatten_dims=2, act="tanh"), [_x(2, 3, 4, 6)], False,
     RTOL),
    ("embedding", lambda p, i: p.layers.embedding(i, [9, 4], padding_idx=3), [_ids(3, 3, 5)], False,
     RTOL),
    ("conv2d", lambda p, x: p.layers.conv2d(x, 4, 3, padding=1, act="relu"), [IMG], False, RTOL),
    ("conv2d_nchw", lambda p, x: p.layers.conv2d(x, 2, 2, stride=2, data_format="NCHW"),
     [_x(4, 2, 3, 6, 6)], False, RTOL),
    ("conv2d_transpose", lambda p, x: p.layers.conv2d_transpose(x, 4, 3, stride=2, padding=1),
     [IMG], False, RTOL),
    ("batch_norm_train", lambda p, x: p.layers.batch_norm(x, act="relu"), [IMG], True, RTOL),
    ("batch_norm_eval", lambda p, x: p.layers.batch_norm(x), [IMG], False, RTOL),
    ("layer_norm", lambda p, x: p.layers.layer_norm(x, begin_norm_axis=2), [_x(5, 3, 4, 6)], False,
     RTOL),
    ("prelu_all", lambda p, x: p.layers.prelu(x), [IMG], False, RTOL),
    ("prelu_channel", lambda p, x: p.layers.prelu(x, "channel"), [IMG], False, RTOL),
    ("prelu_element", lambda p, x: p.layers.prelu(x, "element"), [IMG], False, RTOL),
    ("dynamic_lstm", lambda p, x, l: p.layers.dynamic_lstm(x, 4, l, is_reverse=True),
     [_x(6, 3, 5, 3), LENS], False, RNN_RTOL),
    ("dynamic_gru", lambda p, x, l: p.layers.dynamic_gru(x, 4, l), [_x(7, 3, 5, 3), LENS], False,
     RNN_RTOL),
    ("dynamic_gru_preprojected", lambda p, x: p.layers.dynamic_gru(x, 2, proj_input=False),
     [_x(8, 3, 5, 6)], False, RNN_RTOL),
    ("sequence_conv", lambda p, x, l: p.layers.sequence_conv(x, l, 4, 3, act="tanh"),
     [_x(9, 3, 5, 3), LENS], False, RTOL),
    ("conv3d", lambda p, x: p.layers.conv3d(x, 3, 2, act="relu"), [_x(10, 2, 4, 4, 5, 2)], False,
     RTOL),
    ("conv3d_transpose", lambda p, x: p.layers.conv3d_transpose(x, 3, 2, stride=2),
     [_x(11, 1, 3, 2, 3, 2)], False, RTOL),
    ("hsigmoid", lambda p, x, y: p.layers.hsigmoid(x, y, 7), [_x(12, 4, 3), _ids(12, 4, high=7)],
     False, RTOL),
    ("row_conv", lambda p, x, l: p.layers.row_conv(x, 2, l, act="relu"), [_x(13, 3, 5, 4), LENS],
     False, RTOL),
    ("gru_unit", lambda p, x, h: p.layers.gru_unit(x, h, 12), [_x(14, 3, 12), _x(15, 3, 4)], False,
     RTOL),
    ("lstm_unit", lambda p, x, h, c: p.layers.lstm_unit(x, h, c, forget_bias=1.0),
     [_x(16, 3, 5), _x(17, 3, 4), _x(18, 3, 4)], False, RTOL),
    ("dynamic_lstmp", lambda p, x, l: p.layers.dynamic_lstmp(x, 16, 3, l, cell_clip=0.5,
                                                             proj_activation="tanh"),
     [_x(19, 3, 5, 16), LENS], False, RNN_RTOL),
    ("create_global_var", lambda p, x: x + p.layers.create_global_var([2], 1.5, name="gv"),
     [_x(20, 2)], False, RTOL),
    ("simple_img_conv_pool", lambda p, x: p.nets.simple_img_conv_pool(x, 3, 3, 2, 2, act="relu"),
     [IMG], False, RTOL),
    ("img_conv_group", lambda p, x: p.nets.img_conv_group(x, [2, 3], 2, conv_act="relu",
                                                          conv_with_batchnorm=True, pool_stride=2),
     [IMG], True, RTOL),
    ("sequence_conv_pool", lambda p, x, l: p.nets.sequence_conv_pool(x, l, 4, 3),
     [_x(21, 3, 5, 3), LENS], False, RTOL),
    ("glu", lambda p, x: p.nets.glu(p.layers.fc(x, 8), -1), [_x(22, 3, 4)], False, RTOL),
    ("scaled_dot_product_attention", lambda p, q, k, v: p.nets.scaled_dot_product_attention(
        p.layers.fc(q, 8, num_flatten_dims=2), k, v, num_heads=2),
     [_x(23, 2, 8, 4), _x(24, 2, 8, 8), _x(25, 2, 8, 8)], False, RTOL),
]


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-6)


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_names_shapes_and_outputs_match_jax(case):
    name, fn, args, is_train, rtol = case
    jm, tmod = jpt.build(lambda *a: fn(jpt, *a)), tpt.build(lambda *a: fn(tpt, *a))
    jv = jm.init(0, *(jnp.asarray(a) for a in args))
    tv = tmod.init(0, *(torch.from_numpy(a) for a in args), device="cpu")
    for kind, j_d, t_d in (("params", jv.params, tv.params), ("state", jv.state, tv.state)):
        assert sorted(t_d) == sorted(j_d), (kind, sorted(t_d), sorted(j_d))
        for k in j_d:
            assert tuple(t_d[k].shape) == tuple(np.shape(j_d[k])), (kind, k)
    carried = convert.variables_from_jax(jv, "cpu")
    j_out, j_state = jm.apply(jv, *(jnp.asarray(a) for a in args), is_train=is_train)
    t_out, t_state = tmod.apply(carried, *(torch.from_numpy(a) for a in args), is_train=is_train)
    j_leaves, t_leaves = _leaves(j_out), _leaves(t_out)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == tuple(np.shape(j))
        assert _rel(t.detach().numpy(), j) <= rtol, name
    for k in j_state:
        assert _rel(t_state[k].numpy(), j_state[k]) <= rtol, k


@pytest.mark.parametrize("flash", [False, True])
def test_nets_attention_with_flash_on_and_off(flash):
    """On CPU tensors the flash route runs the kernels' plain versions: the
    output and gradients equal the JAX package's (composed) attention."""
    q, k, v = _x(30, 2, 16, 8), _x(31, 2, 16, 8), _x(32, 2, 16, 8)
    want = jpt.nets.scaled_dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)), num_heads=2)
    jg = jax.grad(lambda a, b, c: jnp.sum(jpt.nets.scaled_dot_product_attention(a, b, c, 2) ** 2),
                  (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    old = tcfg.flags().use_flash_attention
    tcfg.set_flags(use_flash_attention=flash)
    try:
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        got = tpt.nets.scaled_dot_product_attention(*ts, num_heads=2)
        grads = torch.autograd.grad((got ** 2).sum(), ts)
    finally:
        tcfg.set_flags(use_flash_attention=old)
    assert _rel(got.detach().numpy(), want) <= RTOL
    for g, w in zip(grads, jg):
        assert _rel(g, w) <= 1e-4


def test_nce_layer_names_and_a_finite_loss():
    x, y = _x(40, 4, 3), _ids(40, 4, high=10)
    jv = jpt.build(lambda a, b: jpt.layers.nce(a, b, 10, 3)).init(0, jnp.asarray(x), jnp.asarray(y))
    model = tpt.build(lambda a, b: tpt.layers.nce(a, b, 10, 3))
    tv = model.init(0, torch.from_numpy(x), torch.from_numpy(y), device="cpu")
    assert {k: tuple(v.shape) for k, v in tv.params.items()} == {
        k: tuple(np.shape(v)) for k, v in jv.params.items()}
    out, _ = model.apply(convert.variables_from_jax(jv, "cpu"), torch.from_numpy(x),
                         torch.from_numpy(y))
    assert tuple(out.shape) == (4,) and bool(torch.isfinite(out).all()) and bool((out > 0).all())


def test_autoincreased_step_counter_across_applies():
    def net(p):
        return lambda x: x * 0 + p.layers.autoincreased_step_counter(begin=3, step=2)

    jm, tm = jpt.build(net(jpt)), tpt.build(net(tpt))
    jv = jm.init(0, jnp.zeros(1))
    tv = tm.init(0, torch.zeros(1), device="cpu")
    (jout, jstate), (tout, tstate) = jm.apply(jv, jnp.zeros(1)), tm.apply(
        convert.variables_from_jax(jv, "cpu"), torch.zeros(1))
    assert float(tout[0]) == float(jout[0]) == 3.0
    t2, _ = tm.apply(tpt.Variables(tv.params, tstate), torch.zeros(1))
    j2, _ = jm.apply(jpt.framework.Variables(jv.params, jstate), jnp.zeros(1))
    assert float(t2[0]) == float(j2[0]) == 5.0
    assert tv.state["@STEP_COUNTER@"].dtype == torch.int64  # INDEX_DTYPE; int32 in JAX


def test_tensor_helpers():
    L = tpt.layers
    a = L.assign(np.arange(3, dtype=np.float32), device="cpu")
    assert torch.equal(a, torch.arange(3.0)) and L.assign(a) is a
    assert L.create_tensor("int32", device="cpu").dtype == torch.int32
    f = L.fill_constant_batch_size_like(torch.zeros(5, 2), [-1, 3], "float32", 2.5)
    assert tuple(f.shape) == (5, 3) and float(f.sum()) == 37.5
    assert torch.equal(L.sums([a, a, a]), 3 * a)
    assert L.is_empty(torch.zeros(0, 3)) and not L.is_empty(a)
    spec = L.data("x", [None, 3], "int64")
    assert spec.shape == (None, 3) and spec.dtype == torch.int64
    jspec = jpt.layers.data("x", [2, 3], "float32")
    assert L.data("x", [2, 3], "float32").shape == jspec.shape


def test_print_passes_the_value_through(capsys):
    x = torch.tensor([1.5, 2.0])
    assert tpt.layers.Print(x, message="x = ") is x
    assert "x = " in capsys.readouterr().out


def test_control_flow_adapters():
    L = tpt.layers
    out = L.While(lambda v: v[0] < 5)(lambda v: (v[0] + 1, v[1] * 2), (0, 1))
    assert out == (5, 32)
    sw = L.Switch().case(torch.tensor(False), lambda x: x + 1).case(
        torch.tensor(True), lambda x: x + 10).default(lambda x: x)
    assert float(sw.build(torch.tensor(1.0))) == 11.0
    assert float(L.IfElse(torch.tensor(True))(lambda x: x * 2, lambda x: x, torch.tensor(3.0))) == 6.0
    xs, h0 = _x(41, 4, 2, 3), _x(42, 2, 3)  # time-major

    def step(h, x):
        h = h * 0.5 + x
        return h, h * 2

    final, ys = L.StaticRNN(step)(torch.from_numpy(h0), torch.from_numpy(xs))
    jf, jy = jpt.ops.control_flow.static_rnn(step, jnp.asarray(xs), jnp.asarray(h0), time_major=True)
    np.testing.assert_allclose(final.numpy(), np.asarray(jf), atol=1e-6)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jy), atol=1e-6)
    xb, lens = _x(43, 2, 4, 3), np.array([4, 1], np.int32)
    final, ys = L.DynamicRNN(step)(torch.from_numpy(h0), torch.from_numpy(xb), torch.from_numpy(lens))
    jf, jy = jpt.ops.control_flow.dynamic_rnn(step, jnp.asarray(xb), jnp.asarray(lens),
                                              jnp.asarray(h0))
    np.testing.assert_allclose(final.numpy(), np.asarray(jf), atol=1e-6)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jy), atol=1e-6)


def test_auc_matches_jax():
    r = np.random.RandomState(44)
    probs = r.uniform(size=(64, 2)).astype(np.float32)
    labels = (r.uniform(size=(64, 1)) < probs[:, 1:]).astype(np.int32)
    want = jpt.layers.auc(jnp.asarray(probs), jnp.asarray(labels), 50)
    got = tpt.layers.auc(torch.from_numpy(probs), torch.from_numpy(labels), 50)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_chunk_eval_matches_jax():
    r = np.random.RandomState(45)
    inferred = r.randint(0, 7, size=(4, 9)).astype(np.int32)  # 3 chunk types + O (6)
    label = np.where(r.uniform(size=(4, 9)) < 0.7, inferred, r.randint(0, 7, size=(4, 9)))
    lens = np.array([9, 4, 0, 7], np.int32)
    want = jpt.layers.chunk_eval(*(jnp.asarray(a) for a in (inferred, label.astype(np.int32), lens)),
                                 3)
    got = tpt.layers.chunk_eval(*(torch.from_numpy(a) for a in (inferred, label.astype(np.int32),
                                                                lens)), 3)
    assert [int(g) for g in got] == [int(w) for w in want]
    assert all(g.dtype == torch.int32 for g in got)


def test_recordio_readers_are_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpt.layers.open_recordio_file("data.recordio")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpt.layers.open_files(["a.recordio", "b.recordio"])


def test_reader_layers(tmp_path):
    L = tpt.layers
    gen = L.random_data_generator(-1.0, 1.0, [(2,), (3, 1)], seed=4, count=3)
    jgen = jpt.layers.random_data_generator(-1.0, 1.0, [(2,), (3, 1)], seed=4, count=3)
    for a, b in zip(gen(), jgen()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    r = L.py_reader(capacity=4, shapes=[(2,), (3, 1)], dtypes=["float32", "float32"], place="cpu")
    r.decorate_paddle_reader(gen)
    batches = list(r)
    assert len(batches) == 3 and all(isinstance(t, torch.Tensor) for t in batches[0])
    np.testing.assert_array_equal(batches[0][0].numpy(), next(iter(gen()))[0])
    assert len(list(L.double_buffer(gen, place="cpu")())) == 3
    p = L.Preprocessor(gen)
    p.block(lambda a, b: (a * 2, b))
    np.testing.assert_array_equal(next(iter(p()))[0], next(iter(gen()))[0] * 2)
    assert L.read_file(gen)[1].shape == (3, 1)
    assert len(list(L.batch(gen, 2)())) == 1 and L.shuffle is tpt.reader.shuffle
    variables = tpt.Variables({"w": torch.arange(3.0)}, {})
    tpt.io.save_params(str(tmp_path), variables)
    loaded = L.load(str(tmp_path), device="cpu")
    assert torch.equal(loaded.params["w"], torch.arange(3.0))

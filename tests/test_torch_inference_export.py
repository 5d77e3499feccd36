"""The port's inference deployment against the JAX package on the CPU: BN
folding (``transpiler/inference.py``), the exported inference program
(``io.save_inference_model``/``load_inference_model``) and the flash
forward's operator (``paddle_tpu_torch::flash_fwd``).

Tolerances: folded weights at atol 1e-6 against the JAX package's (the
same f32 arithmetic on the same stored layout); a folded forward against
the unfolded one at ``tests/test_transpiler.py``'s rtol 2e-4 / atol 2e-5
(the fold reassociates the BN arithmetic); a loaded program bit for bit
against the eager ``apply(is_train=False)`` (the same operators on the
same inputs) and at rtol 1e-5 / atol 1e-5 against the JAX package's
exported program (f32 sums in other orders). The JAX LM runs its flash
path as its own tests run it on the CPU.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.transpiler import inference as jinference
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, framework, io
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.models import get_model, transformer_lm
from paddle_tpu_torch.ops.cuda.flash_attention import (
    _reference_attention_with_lse,
    flash_fwd_op,
)
from paddle_tpu_torch.transpiler import inference as tinference

FOLD_ATOL = 1e-6
FOLD_RTOL, FOLD_OUT_ATOL = 2e-4, 2e-5  # tests/test_transpiler.py's
JAX_RTOL = JAX_ATOL = 1e-5


def _jit_init(model, *args):
    """The JAX model's init(0) jitted: the same values as the eager init,
    a compile instead of an op-by-op run (seconds at these sizes)."""
    return jax.jit(lambda *a: model.init(0, *a))(*args)


def _tconv_bn(x):
    h = pt.layers.conv2d(x, num_filters=8, filter_size=3, padding=1, bias_attr=False)
    h = pt.layers.batch_norm(h, act="relu")
    h = pt.layers.conv2d(h, num_filters=4, filter_size=3, padding=1)
    return pt.layers.batch_norm(h)


def _jconv_bn(x):
    h = jpt.layers.conv2d(x, num_filters=8, filter_size=3, padding=1, bias_attr=False)
    h = jpt.layers.batch_norm(h, act="relu")
    h = jpt.layers.conv2d(h, num_filters=4, filter_size=3, padding=1)
    return jpt.layers.batch_norm(h)


def _nontrivial(params, state, rng):
    """test_transpiler.py's BN statistics and weights, drawn once (numpy)."""
    state = {k: rng.rand(*np.shape(v)).astype(np.float32) + 0.5 for k, v in state.items()}
    params = {k: rng.randn(*np.shape(v)).astype(np.float32) * 0.5
              + (1.0 if k.endswith("scale") else 0.0) for k, v in params.items()}
    return params, state


def _fold_both(tmodel, jmodel, np_params, np_state, x):
    tvars = framework.Variables(convert.params_from_jax(np_params, "cpu"),
                                convert.params_from_jax(np_state, "cpu"))
    jvars = JVariables({k: jnp.asarray(v) for k, v in np_params.items()},
                       {k: jnp.asarray(v) for k, v in np_state.items()})
    pairs = tinference.find_conv_bn_pairs(tvars)
    assert sorted(pairs) == sorted(jinference.find_conv_bn_pairs(jvars))
    predict, folded = tinference.inference_optimize(tmodel, tvars)
    _, jfolded = jinference.inference_optimize(jmodel, jvars)
    for tree, jtree in ((folded.params, jfolded.params), (folded.state, jfolded.state)):
        assert tree.keys() == jtree.keys()
        for k in tree:
            np.testing.assert_allclose(tree[k].numpy(), np.asarray(jtree[k]), rtol=0,
                                       atol=FOLD_ATOL, err_msg=k)
    with torch.no_grad():
        ref, _ = tmodel.apply(tvars, torch.from_numpy(x), is_train=False)
    out = predict(folded, torch.from_numpy(x))
    return pairs, folded, _first(out), _first(ref)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def test_fold_conv_bn_matches_jax_and_keeps_the_output():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    jmodel = jpt.build(_jconv_bn)
    jv = _jit_init(jmodel, jnp.asarray(x))
    params, state = _nontrivial(jv.params, jv.state, rng)
    pairs, folded, out, ref = _fold_both(pt.build(_tconv_bn), jmodel, params, state, x)
    assert len(pairs) == 2
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=FOLD_RTOL, atol=FOLD_OUT_ATOL)
    for _, bn in pairs:
        np.testing.assert_array_equal(folded.params[f"{bn}/scale"].numpy(), 1.0)


def test_fold_tiny_resnet_matches_jax_and_keeps_the_output():
    """ResNet-20 (cifar10 widths, 32 x 32): the port's init (the JAX init of
    the conv zoo runs op by op and is slow) with test_transpiler.py's
    statistics, folded in both packages."""
    spec = get_model("resnet", dataset="cifar10", depth=20, device="cpu")
    rng = np.random.RandomState(1)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    tv = spec.model.init(0, torch.from_numpy(x), torch.zeros(2, dtype=torch.int32), device="cpu")
    params, state = _nontrivial(convert.params_to_numpy(tv.params),
                                convert.params_to_numpy(tv.state), rng)
    jspec = jmodels.get_model("resnet", dataset="cifar10", depth=20)
    tmodel = framework.build(lambda im: spec.model._fn(im, torch.zeros(2, dtype=torch.int32))[2])
    jmodel = jpt.build(lambda im: jspec.model._fn(im, jnp.zeros((2,), jnp.int32))[2])
    pairs, _, out, ref = _fold_both(tmodel, jmodel, params, state, x)
    assert len(pairs) == 21  # 19 residual-branch convs + the stem + 1 shortcut... each with its BN
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=FOLD_RTOL, atol=FOLD_OUT_ATOL)


def _assert_trees(a, b, exact=False):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if exact:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_mnist_program_round_trip_against_eager_and_jax(tmp_path):
    jspec = jmodels.get_model("mnist")
    images, labels = (np.asarray(a) for a in jspec.synth_batch(4, np.random.RandomState(0)))
    jvars = _jit_init(jspec.model, images, labels)
    tspec = get_model("mnist", device="cpu")
    tvars = framework.Variables(convert.params_from_jax(jvars.params, "cpu"),
                                convert.params_from_jax(jvars.state, "cpu"))
    io.save_inference_model(str(tmp_path / "t"), tspec.model, tvars, [images, labels])
    run, loaded = io.load_inference_model(str(tmp_path / "t"), device="cpu")
    assert loaded.params.keys() == tvars.params.keys()
    got = run(images, labels)
    with torch.no_grad():
        eager, _ = tspec.model.apply(tvars, torch.from_numpy(images), torch.from_numpy(labels))
    _assert_trees(got, eager, exact=True)
    jio.save_inference_model(str(tmp_path / "j"), jspec.model, jvars, [images, labels])
    jrun, _ = jio.load_inference_model(str(tmp_path / "j"))
    _assert_trees(got, jrun(images, labels))
    with pytest.raises(NotImplementedError, match="item 8"):
        io.save_inference_model(str(tmp_path / "n"), tspec.model, tvars, [images, labels],
                                native=True)


LM = dict(seq_len=16, vocab=97, d_model=32, d_inner=64, num_heads=4, n_layers=2)


@pytest.fixture
def both_flash():
    saved = (jconfig.flags().use_flash_attention, tconfig.flags().use_flash_attention)
    jconfig.set_flags(use_flash_attention=True)
    tconfig.set_flags(use_flash_attention=True)
    yield
    jconfig.set_flags(use_flash_attention=saved[0])
    tconfig.set_flags(use_flash_attention=saved[1])


def test_lm_program_calls_the_flash_operator(tmp_path, both_flash):
    from paddle_tpu.models import transformer_lm as jtlm

    from paddle_tpu_torch.models import transformer as tnmt

    tnmt._cached_position_table.cache_clear()  # the export below fills it first
    jspec = jmodels.get_model("transformer_lm", **LM)
    ids, labels = (np.asarray(a) for a in jspec.synth_batch(2, np.random.RandomState(0)))
    jvars = _jit_init(jspec.model, ids, labels)
    tspec = get_model("transformer_lm", device="cpu", **LM)
    tvars = framework.Variables(convert.params_from_jax(jvars.params, "cpu"),
                                convert.params_from_jax(jvars.state, "cpu"))
    cfg, jcfg = tspec.extra["cfg"], jspec.extra["cfg"]
    net = framework.build(lambda t: transformer_lm.lm_forward(t, t, cfg=cfg)[2])
    d = str(tmp_path / "lm")
    io.save_inference_model(d, net, tvars, [ids])
    program = torch.export.load(f"{d}/program.pt2")
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.paddle_tpu_torch.flash_fwd.default) == LM["n_layers"]
    assert not any("scaled_dot_product" in str(op) for op in ops)
    run, _ = io.load_inference_model(d, device="cpu")
    with torch.no_grad():
        eager, _ = net.apply(tvars, torch.from_numpy(ids))
    got = run(ids)
    assert torch.equal(got, eager)
    jnet = jpt.build(lambda t: jtlm.lm_forward(t, t, cfg=jcfg)[2])
    jio.save_inference_model(str(tmp_path / "j"), jnet, jvars, [ids])
    jrun, _ = jio.load_inference_model(str(tmp_path / "j"))
    np.testing.assert_allclose(got.numpy(), np.asarray(jrun(ids)), rtol=JAX_RTOL, atol=JAX_ATOL)


@pytest.mark.parametrize("case", [
    dict(B=2, H=4, H_kv=4, T=16, T_kv=16, causal=True),
    dict(B=2, H=4, H_kv=4, T=8, T_kv=24, causal=False, kv_len=[5, 24]),
    dict(B=1, H=8, H_kv=2, T=12, T_kv=12, causal=True, window=4),
    dict(B=2, H=4, H_kv=1, T=8, T_kv=8, causal=True, q_off=8, k_off=0),
], ids=["causal", "kv_len", "gqa_window", "gqa_offsets"])
def test_flash_operator_fake_shapes_equal_the_real_ones(case):
    g = torch.Generator().manual_seed(0)
    d = 32
    q = torch.randn(case["B"], case["H"], case["T"], d, generator=g)
    k = torch.randn(case["B"], case["H_kv"], case["T_kv"], d, generator=g)
    v = torch.randn(case["B"], case["H_kv"], case["T_kv"], d, generator=g)
    kv_len = torch.tensor(case["kv_len"], dtype=torch.int32) if "kv_len" in case else None
    args = (case["causal"], d ** -0.5, case.get("window"), case.get("q_off", 0),
            case.get("k_off", 0))
    out, lse = flash_fwd_op(q, k, v, kv_len, *args)
    ref, ref_lse = _reference_attention_with_lse(q, k, v, case["causal"], d ** -0.5, kv_len,
                                                 case.get("window"), *args[3:])
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fl = mode.from_tensor(kv_len) if kv_len is not None else None
        fout, flse = flash_fwd_op(fq, fk, fv, fl, *args)
    assert (fout.shape, fout.dtype) == (out.shape, out.dtype)
    assert (flse.shape, flse.dtype) == (lse.shape, lse.dtype) == \
        (torch.Size(q.shape[:3] + (1,)), torch.float32)
    torch.library.opcheck(flash_fwd_op, (q, k, v, kv_len, *args))


def test_beam_search_program_round_trips_and_data_dependent_code_raises(tmp_path):
    """The beam-search model that tests/test_book.py exports in the JAX
    package is fixed-length tensor code, so torch.export captures it: the
    loaded program equals the eager decode. A program whose Python control
    flow reads a tensor's value raises the exporter's own error."""
    spec = get_model("machine_translation", vocab_size=20, emb_dim=8, hidden_dim=8,
                     seq_len=6, device="cpu")
    batch = spec.synth_batch(2, np.random.RandomState(0))
    v = spec.model.init(0, *batch, device="cpu")
    infer = spec.extra["make_infer_model"](beam_size=2, max_len=6, bos_id=0, eos_id=1)
    src, lens = batch[0], batch[1]
    shared = framework.Variables(v.params, infer.init(0, src, lens, device="cpu").state)
    io.save_inference_model(str(tmp_path / "beam"), infer, shared, [src, lens])
    run, _ = io.load_inference_model(str(tmp_path / "beam"), device="cpu")
    with torch.no_grad():
        (seqs, scores), _ = infer.apply(shared, src, lens, is_train=False)
    got_seqs, got_scores = run(src, lens)
    assert torch.equal(got_seqs, seqs) and torch.equal(got_scores, scores)

    def branchy(x):
        h = pt.layers.fc(x, size=3)
        return h * 2 if float(h.sum()) > 0 else h

    model = pt.build(branchy)
    x = torch.randn(2, 4)
    with pytest.raises(Exception, match="data-dependent"):
        io.save_inference_model(str(tmp_path / "bad"), model, model.init(0, x, device="cpu"), [x])

"""The port's model lint (``paddle_tpu_torch/analysis/model_lint.py``, a
trace on the ``meta`` device) against the JAX package's (``jax.eval_shape``).

Each fixture model of ``tests/test_analysis_model_lint.py`` is built in both
packages with the same layers and names, and both lints must give the same
``(code, severity, where)`` findings; the JAX test's own assertion is then
made of the port's. The eight models of ``get_model`` at small widths lint
with no error, in eval and training mode, with the JAX lint's warnings; so
does the BN-folded ResNet-50 that phase ``infer`` serves. Then the port's
own contracts: inputs as tensors, arrays or ``(shape, dtype)`` specs; a
read of a value on the host is reported with the op named, not swallowed;
``ServingEngine`` lints before warm-up (no "model lint skipped" for the
tiny LM; a planted f64 parameter in its log).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.framework as jfw
import paddle_tpu_torch.framework as tfw
from paddle_tpu import models as jmodels
from paddle_tpu.analysis import lint_model as jlint
from paddle_tpu.regularizer import L2Decay as JL2Decay
from paddle_tpu_torch import convert
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.analysis import lint_model as tlint
from paddle_tpu_torch.analysis.diagnostics import ERROR, WARNING, has_errors
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.regularizer import L2Decay as TL2Decay

X = np.zeros((2, 4), np.float32)


def _key(diags):
    return sorted((d.code, d.severity, d.where) for d in diags)


def _by_code(diags, code):
    return [d for d in diags if d.code == code]


def _both(jnet, tnet, inputs=(X,), **kw):
    """Both lints of the same fixture; returns the port's findings after
    holding them to the JAX lint's."""
    jd = jlint(jfw.build(jnet, name="net"), list(inputs), **kw)
    td = tlint(tfw.build(tnet, name="net"), list(inputs), **kw)
    assert _key(td) == _key(jd)
    return td


# ---- the JAX test's fixtures, built in both packages ----------------------


def test_clean_model_is_clean():
    def jnet(x):
        w = jfw.create_parameter((4, 3), "float32", name="w")
        b = jfw.create_parameter((3,), "float32", name="b")
        m = jfw.create_state("calls", (), "float32")
        jfw.update_state("calls", m + 1.0)
        return jnp.tanh(x @ w + b)

    def tnet(x):
        w = tfw.create_parameter((4, 3), "float32", name="w")
        b = tfw.create_parameter((3,), "float32", name="b")
        m = tfw.create_state("calls", (), "float32")
        tfw.update_state("calls", m + 1.0)
        return torch.tanh(x @ w + b)

    assert _both(jnet, tnet) == []


def test_nothing_is_ever_computed():
    seen = []

    def jtrap(key, shape, dtype):
        return jnp.zeros(shape, dtype)

    def ttrap(generator, shape, dtype, device):
        seen.append(torch.device(device))
        return torch.zeros(shape, dtype=dtype, device=device)

    def jnet(x):
        return x @ jfw.create_parameter((4, 3), "float32", name="w", default_initializer=jtrap)

    def tnet(x):
        return x @ tfw.create_parameter((4, 3), "float32", name="w", default_initializer=ttrap)

    assert _both(jnet, tnet, inputs=[jax.ShapeDtypeStruct((2, 4), np.float32)]) == []
    # the initializer ran as Python, on the meta device: no data was made
    assert seen == [torch.device("meta")]


def test_sharding_rank_mismatch():
    def jnet(x):
        return x @ jfw.create_parameter((4, 3), "float32", name="w",
                                        attr=jfw.ParamAttr(sharding=("model",)))

    def tnet(x):
        return x @ tfw.create_parameter((4, 3), "float32", name="w",
                                        attr=tfw.ParamAttr(sharding=("model",)))

    (d,) = _by_code(_both(jnet, tnet), "sharding-rank")
    assert d.severity == ERROR and "w" in d.where


def test_init_apply_mismatch():
    def jnet(x):
        if not jfw.is_initializing():
            return x @ jfw.create_parameter((4, 3), "float32", name="late_w")
        return x

    def tnet(x):
        if not tfw.is_initializing():
            return x @ tfw.create_parameter((4, 3), "float32", name="late_w")
        return x

    diags = _both(jnet, tnet)
    assert _by_code(diags, "init-apply-mismatch") and has_errors(diags)


def test_param_collision_on_explicit_names():
    def jnet(x):
        a = jfw.create_parameter((4, 3), "float32", attr=jfw.ParamAttr(name="w"))
        b = jfw.create_parameter((4, 3), "float32", attr=jfw.ParamAttr(name="w"))
        return x @ (a + b)

    def tnet(x):
        a = tfw.create_parameter((4, 3), "float32", attr=tfw.ParamAttr(name="w"))
        b = tfw.create_parameter((4, 3), "float32", attr=tfw.ParamAttr(name="w"))
        return x @ (a + b)

    assert _by_code(_both(jnet, tnet), "param-collision")


def test_unused_param_warning():
    def jnet(x):
        if jfw.is_initializing():
            jfw.create_parameter((7,), "float32", name="orphan")
        return x @ jfw.create_parameter((4, 3), "float32", name="w")

    def tnet(x):
        if tfw.is_initializing():
            tfw.create_parameter((7,), "float32", name="orphan")
        return x @ tfw.create_parameter((4, 3), "float32", name="w")

    diags = _both(jnet, tnet)
    (d,) = _by_code(diags, "unused-param")
    assert d.severity == WARNING and "orphan" in d.where
    assert not has_errors(diags)


def test_unused_param_sees_through_layer_stacks():
    """The JAX fixture reads its layers through ``scan_layer_stack``; the
    port runs the plain layer loop (``scan_layer_stack`` is not applicable
    there) and stacks layers through ``gather_layer_params`` (the pipeline's
    path): the read ledger must count both as reads."""
    n_layers = 3

    def jbody(h, scope):
        with jfw.name_scope(scope):
            w = jfw.create_parameter((4, 4), "float32", name="w")
        return h @ w

    def jnet(x):
        if jfw.is_initializing():
            for i in range(n_layers):
                x = jbody(x, f"blk_{i}")
            return x
        return jfw.scan_layer_stack(x, n_layers, lambda i: f"blk_{i}", template="blk_0",
                                    body=jbody)

    def tbody(h, scope):
        with tfw.name_scope(scope):
            w = tfw.create_parameter((4, 4), "float32", name="w")
        return h @ w

    def tnet(x):
        for i in range(n_layers):
            x = tbody(x, f"blk_{i}")
        return x

    assert _by_code(_both(jnet, tnet), "unused-param") == []

    def tnet_stacked(x):
        if tfw.is_initializing():
            for i in range(n_layers):
                x = tbody(x, f"blk_{i}")
            return x
        stacked = tfw.gather_layer_params(n_layers, lambda i: f"blk_{i}")
        for i in range(n_layers):
            with tfw.overlay_frame({"blk_0/w": stacked["w"][i]}):  # layer i as the template
                x = tbody(x, "blk_0")
        return x

    assert tlint(tfw.build(tnet_stacked, name="net"), [X]) == []


def test_float64_leak():
    def jnet(x):
        return x @ jfw.create_parameter((4, 3), "float64", name="w64").astype(jnp.float32)

    def tnet(x):
        return x @ tfw.create_parameter((4, 3), "float64", name="w64").float()

    diags = _both(jnet, tnet)
    assert any("w64" in d.where for d in _by_code(diags, "float64-leak"))


def test_stale_state_warning_train_only():
    def jnet(x):
        jfw.create_state("never_moves", (3,), "float32")
        return x @ jfw.create_parameter((4, 3), "float32", name="w")

    def tnet(x):
        tfw.create_state("never_moves", (3,), "float32")
        return x @ tfw.create_parameter((4, 3), "float32", name="w")

    (d,) = _by_code(_both(jnet, tnet, train=True), "stale-state")
    assert "never_moves" in d.where and d.severity == WARNING
    # eval-mode models legitimately never touch their statistics
    assert _by_code(_both(jnet, tnet, train=False), "stale-state") == []


def test_cross_scope_state_update_flagged():
    def jnet(x):
        jfw.create_state("counter", (), "float32")
        w = jfw.create_parameter((4, 3), "float32", name="w")
        with jfw.name_scope("blk"):
            jfw.update_state("counter", jnp.float32(1.0))
        return x @ w

    def tnet(x):
        tfw.create_state("counter", (), "float32")
        w = tfw.create_parameter((4, 3), "float32", name="w")
        with tfw.name_scope("blk"):
            tfw.update_state("counter", torch.tensor(1.0))
        return x @ w

    (d,) = _by_code(_both(jnet, tnet), "cross-scope-state")
    assert d.severity == WARNING


def test_regularizer_on_non_trainable():
    def jnet(x):
        return x @ jfw.create_parameter(
            (4, 3), "float32", name="w",
            attr=jfw.ParamAttr(trainable=False, regularizer=JL2Decay(1e-4)))

    def tnet(x):
        return x @ tfw.create_parameter(
            (4, 3), "float32", name="w",
            attr=tfw.ParamAttr(trainable=False, regularizer=TL2Decay(1e-4)))

    (d,) = _by_code(_both(jnet, tnet), "regularizer-non-trainable")
    assert d.severity == WARNING


def test_lint_against_provided_variables():
    def jnet(x):
        return x @ jfw.create_parameter((4, 3), "float32", name="w")

    def tnet(x):
        return x @ tfw.create_parameter((4, 3), "float32", name="w")

    jm, tm = jfw.build(jnet, name="net"), tfw.build(tnet, name="net")
    jv = jm.init(0, X)
    tv = tm.init(0, torch.from_numpy(X), device="cpu")
    jstale = jfw.Variables(params=dict(jv.params, legacy_head=np.zeros((3, 3), np.float32)),
                           state=dict(jv.state))
    tstale = tfw.Variables(params=dict(tv.params, legacy_head=torch.zeros(3, 3)),
                           state=dict(tv.state))
    td = tlint(tm, [X], variables=tstale)
    assert _key(td) == _key(jlint(jm, [X], variables=jstale))
    (d,) = _by_code(td, "unused-param")
    assert "legacy_head" in d.where
    # the given tensors are read for their shapes only: not moved, not changed
    assert tstale.params["w"].device.type == "cpu"
    assert torch.equal(tstale.params["w"], tv.params["w"])


# ---- the port's own contracts ---------------------------------------------


def _tiny():
    def net(x):
        b = tfw.create_parameter((3,), "float32", name="b")
        return x @ tfw.create_parameter((4, 3), "float32", name="w") + b

    return tfw.build(net, name="net")


def test_read_ledger_is_kept_only_for_the_lint():
    """A plain apply keeps no read ledger; one under the lint's recording
    hands its own ledger back, whatever the shared model holds."""
    m = _tiny()
    variables = m.init(0, torch.from_numpy(X), device="cpu")
    m.apply(variables, torch.from_numpy(X))
    assert m._last_param_reads == frozenset() and m._last_param_info == {}
    with tfw._recording_reads() as ledger:
        m.apply(variables, torch.from_numpy(X))
    assert ledger["param_reads"] == frozenset({"b", "w"}) == m._last_param_reads
    assert ledger["state_updates"] == frozenset() and sorted(ledger["param_info"]) == ["b", "w"]


@pytest.mark.parametrize("inputs", [
    [X], [torch.from_numpy(X)], [((2, 4), "float32")], [((2, 4), torch.float32)],
    [((2, 4), np.float32)], [jax.ShapeDtypeStruct((2, 4), np.float32)],
], ids=["numpy", "tensor", "spec_name", "spec_torch", "spec_numpy", "shape_dtype_struct"])
def test_example_inputs_forms(inputs):
    assert tlint(_tiny(), inputs) == []


@pytest.mark.parametrize("given", [False, True], ids=["init", "apply"])
def test_host_read_is_reported_with_the_op(given):
    def net(x):
        w = tfw.create_parameter((4, 3), "float32", name="w")
        scale = float(x.abs().max().item())  # a value on the host: not on meta
        return x @ w * scale

    m = tfw.build(net, name="net")
    variables = m.init(0, torch.from_numpy(X), device="cpu") if given else None
    (d,) = tlint(m, [X], variables=variables)
    assert d.code == ("init-apply-mismatch" if given else "init-error")
    assert d.where == ("net.apply" if given else "net.init") and d.severity == ERROR
    assert "item()" in d.message and "test_torch_model_lint.py" in d.message
    assert "in net" in d.message


def test_other_errors_propagate():
    def net(x):
        raise ZeroDivisionError("a bug in the model")

    with pytest.raises(ZeroDivisionError):
        tlint(tfw.build(net, name="net"), [X])


# ---- the eight models of get_model, and the folded ResNet-50 --------------

MODELS = {
    "transformer_lm": dict(seq_len=16, vocab=64, d_model=32, d_inner=64, num_heads=4,
                           n_layers=2),
    "transformer": dict(seq_len=16, src_vocab=64, trg_vocab=64, d_model=32, d_inner=64,
                        num_heads=4, n_layers=2, max_len=32),
    "resnet": dict(dataset="cifar10", depth=8),
    "se_resnext": dict(depth=50, class_dim=10, image_size=32),
    "vgg": dict(dataset="cifar10"),
    "mnist": dict(),
    "stacked_dynamic_lstm": dict(vocab_size=50, emb_dim=16, hidden_dim=16, stacked_num=2,
                                 seq_len=10),
    "machine_translation": dict(vocab_size=50, emb_dim=16, hidden_dim=16, seq_len=10),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_get_model_models_lint_like_jax(name, train):
    jspec = jmodels.get_model(name, **MODELS[name])
    tspec = tmodels.get_model(name, device="cpu", **MODELS[name])
    batch = jspec.synth_batch(2, np.random.RandomState(0))
    td = tlint(tspec.model, batch, train=train)
    assert not has_errors(td), "\n".join(map(str, td))
    assert _key(td) == _key(jlint(jspec.model, batch, train=train))


def test_folded_resnet50_lints_like_jax():
    from paddle_tpu.models import resnet as jresnet
    from paddle_tpu.transpiler.inference import fuse_batch_norm as jfuse
    from paddle_tpu_torch.models import resnet as tresnet
    from paddle_tpu_torch.transpiler.inference import inference_optimize

    tnet = tfw.build(lambda im: tresnet.resnet_imagenet(im, class_dim=10, depth=50),
                     name="resnet50_logits")
    jnet = jfw.build(lambda im: jresnet.resnet_imagenet(im, class_dim=10, depth=50),
                     name="resnet50_logits")
    images = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    tvars = tnet.init(0, torch.from_numpy(images), device="cpu")
    _, tfolded = inference_optimize(tnet, tvars)
    jvars = jfw.Variables(params=convert.params_to_numpy(tvars.params),
                          state=convert.params_to_numpy(tvars.state))
    jfolded = jfuse(jvars)
    assert set(jfolded.params) == set(tfolded.params)
    td = tlint(tnet, [images[:1]], variables=tfolded, train=False)
    assert not has_errors(td)
    assert _key(td) == _key(jlint(jnet, [images[:1]], variables=jfolded, train=False))


# ---- ServingEngine lints before warm-up -----------------------------------


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def engine_log():
    handler = _Records()
    ptlog.reset_warn_once()
    ptlog.get_logger().addHandler(handler)
    yield handler.lines
    ptlog.get_logger().removeHandler(handler)


def _serve(net, variables, feed, request):
    from paddle_tpu_torch.reader.feeder import FeedSpec
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    engine = ServingEngine(net, variables, [FeedSpec(*feed)],
                           config=ServingConfig(max_batch_size=2, num_replicas=1,
                                                length_buckets=(8, 16)), place="cpu")
    try:
        return engine.submit(request).result(timeout=60), engine.lint_findings
    finally:
        assert engine.close(timeout=30) == []


def test_engine_lints_the_tiny_lm(engine_log, monkeypatch):
    from paddle_tpu_torch.analysis import model_lint
    from paddle_tpu_torch.models import transformer_lm

    spec = tmodels.get_model("transformer_lm", device="cpu", **MODELS["transformer_lm"])
    cfg = spec.extra["cfg"]
    rng = np.random.RandomState(0)
    variables = spec.model.init(0, *spec.synth_batch(1, rng), device="cpu")
    net = tfw.build(lambda tokens: transformer_lm.lm_forward(tokens, tokens, cfg=cfg)[2],
                    name="transformer_lm_logits")
    lints, applied_on = [], []
    real_lint, real_apply = model_lint.lint_model, net.apply

    def lint(*a, **k):
        lints.append(a[0])
        return real_lint(*a, **k)

    def apply(v, *a, **k):
        applied_on.append(next(iter(v.params.values())).device.type)
        return real_apply(v, *a, **k)

    monkeypatch.setattr(model_lint, "lint_model", lint)
    monkeypatch.setattr(net, "apply", apply)
    out, findings = _serve(net, variables, ("tokens", (None,), "int32"),
                           {"tokens": rng.randint(1, 64, size=(1, 5)).astype(np.int32)})
    assert tuple(out.shape) == (1, 8, 64)
    assert not any("model lint" in line for line in engine_log), engine_log
    # the lint ran once, traced on meta before anything was served, and found nothing
    assert lints == [net] and applied_on[0] == "meta" and applied_on.count("meta") == 1
    assert findings == []


def test_engine_reports_a_planted_float64_parameter(engine_log):
    def net(x):
        w = tfw.create_parameter((4, 3), "float64", name="w64")
        return x @ w.float()

    m = tfw.build(net, name="f64_net")
    variables = m.init(0, torch.from_numpy(X), device="cpu")
    out, findings = _serve(m, variables, ("x", (4,), "float32"), {"x": X[:1]})
    assert tuple(out.shape) == (1, 3)
    assert [(d.code, d.where) for d in findings] == [("float64-leak", "w64")]
    lint = [line for line in engine_log if "model lint" in line]
    assert len(lint) == 1 and "[float64-leak]" in lint[0] and "w64" in lint[0], engine_log
    assert "skipped" not in lint[0]


def test_engine_lint_failure_never_blocks_serving(engine_log, monkeypatch):
    from paddle_tpu_torch.analysis import model_lint

    def broken(*a, **k):
        raise RuntimeError("lint broke")

    monkeypatch.setattr(model_lint, "lint_model", broken)
    out, findings = _serve(_tiny(), _tiny().init(0, torch.from_numpy(X), device="cpu"),
                           ("x", (4,), "float32"), {"x": X[:1]})
    assert tuple(out.shape) == (1, 3) and findings is None
    assert any("model lint skipped: lint broke" in line for line in engine_log), engine_log

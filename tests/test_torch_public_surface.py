"""The port's public surface against the JAX package's.

For the top level and every module both packages have, each name of the
JAX module's ``__all__`` (else its public functions and classes) must be
in the port's module, except the names listed here as not applicable (each
named as such in the port module's docstring) or as still to port (each an
item of ``ROADMAP.md`` §A); the lists must stay exact, so the surface
cannot drift either way. Then the names this surface added are held
against the JAX functions on the same numpy inputs: the three new
initializers, ``WeightNormParamAttr`` through ``layers.fc`` (the same
parameters, forward and gradients, as ``tests/test_framework.py:137``
checks in the JAX package), ``core.dtypes``' policy, the positional
binding of ``ops.attention.scaled_dot_product_attention``, and the Fluid
names of the top level (``fluid.Executor(fluid.CPUPlace())``).

Tolerances: deterministic values (Bilinear, the weight-norm forward and
gradients, attention) at 1e-6; random initializers by their support and
first two moments over 200,000 draws (a ``torch.Generator`` is not a JAX
key, so the draws themselves differ).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import importlib
import inspect
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import initializer as jinit
from paddle_tpu.core import config as jconfig
from paddle_tpu.core import dtypes as jdtypes
from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch import initializer as tinit
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core import dtypes as tdtypes
from paddle_tpu_torch.ops import attention as tattn

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# names of the JAX package the port does not have, because they do not
# apply to PyTorch on a card; each port module names its own in its
# docstring
NOT_APPLICABLE = {
    "paddle_tpu": {"TPUPlace"},
    "paddle_tpu.core.config": {"TPUPlace", "apply_compile_cache"},
    "paddle_tpu.framework": {"next_rng_key", "scan_layer_stack", "stack_layer_params"},
    "paddle_tpu.models.transformer_lm": {"stack_decode_params"},
    "paddle_tpu.observability.mfu": {"cost_analysis_totals", "lowered_flops"},
}
# names still to port, by their ROADMAP.md §A item
STILL_TO_PORT = {
    "paddle_tpu": {"recordio_writer"},  # item 8
    "paddle_tpu.reader": {"recordio"},  # item 8
    "paddle_tpu.analysis": {  # item 8 (the verifier)
        "VerificationError", "verify_or_raise", "verify_program", "verify_text"},
    "paddle_tpu.dataset": {  # item 10
        "cifar", "conll05", "flowers", "imdb", "imikolov", "mnist", "movielens", "mq2007",
        "sentiment", "uci_housing", "voc2012", "wmt14", "wmt16"},
}


def _shared_modules():
    """Every module of the JAX package whose file the port also has (read
    from the file tree: the same list on every worker)."""
    out = []
    for dirpath, _, files in os.walk(os.path.join(_ROOT, "paddle_tpu")):
        rel = os.path.relpath(dirpath, _ROOT)
        for f in sorted(files):
            if not f.endswith(".py") or f == "__main__.py":
                continue
            port = os.path.join(_ROOT, rel.replace("paddle_tpu", "paddle_tpu_torch", 1), f)
            if os.path.exists(port):
                mod = rel.replace(os.sep, ".") + ("" if f == "__init__.py" else "." + f[:-3])
                out.append(mod)
    return sorted(out)


def _public(mod):
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == mod.__name__}


@pytest.mark.parametrize("name", _shared_modules())
def test_module_names_match_jax(name):
    jmod = importlib.import_module(name)
    tmod = importlib.import_module(name.replace("paddle_tpu", "paddle_tpu_torch", 1))
    na, owed = NOT_APPLICABLE.get(name, set()), STILL_TO_PORT.get(name, set())
    missing = _public(jmod) - set(dir(tmod))
    assert missing == na | owed, f"{name}: missing {sorted(missing - na - owed)}, listed but " \
                                 f"present {sorted((na | owed) - missing)}"
    for n in na:  # named in the module's docstring as not applicable
        assert n in (tmod.__doc__ or ""), f"{tmod.__name__}'s docstring does not name {n}"
    for n in getattr(tmod, "__all__", ()):
        assert hasattr(tmod, n), f"{tmod.__name__}.__all__ names {n}, which it lacks"


def test_analysis_all_is_the_jax_one_less_the_verifier():
    import paddle_tpu.analysis as janalysis
    import paddle_tpu_torch.analysis as tanalysis

    assert set(tanalysis.__all__) == set(janalysis.__all__) - STILL_TO_PORT["paddle_tpu.analysis"]
    for n in tanalysis.__all__:  # each loads (lazily) and is what the module says
        assert callable(getattr(tanalysis, n)) or n in ("ERROR", "WARNING"), n


def test_top_level_all_and_fluid_main_path():
    assert set(pt.__all__) == set(jpt.__all__) - NOT_APPLICABLE["paddle_tpu"] \
        - STILL_TO_PORT["paddle_tpu"]
    assert pt.ParallelExecutor is pt.DataParallel
    fluid = pt
    exe = fluid.Executor(fluid.CPUPlace())
    assert exe.device == torch.device("cpu")
    out = exe.run(lambda x: x * 2, torch.ones(3), fetch=True)
    np.testing.assert_array_equal(out, [2.0, 2.0, 2.0])
    # Places: the JAX package's equality, and what resolve_device makes of them
    assert fluid.CPUPlace() == fluid.CPUPlace() and jconfig.CPUPlace() == jconfig.CPUPlace()
    assert hash(fluid.CUDAPlace(1)) == hash(fluid.CUDAPlace(1)) != hash(fluid.CUDAPlace(0))
    assert fluid.CUDAPlace(1) != fluid.CUDAPlace(0) and fluid.CUDAPlace(0) != fluid.CPUPlace()
    assert fluid.CUDAPlace(1).torch_device() == torch.device("cuda", 1)
    assert repr(fluid.CUDAPlace(2)) == "CUDAPlace(2)" and repr(fluid.CPUPlace()) == "CPUPlace()"
    assert tconfig.default_place() == tconfig.CUDAPlace(0)  # no silent CPU fallback
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fluid.Executor(fluid.CUDAPlace(0))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fluid.Executor(tconfig.default_place())


# -- initializer ----------------------------------------------------------------
def test_bilinear_initializer_equals_jax():
    for shape in ((4, 4, 3, 3), (3, 5, 2, 4), (6, 6, 1, 1)):
        j = np.asarray(jinit.Bilinear()(jax.random.PRNGKey(0), shape, jnp.float32))
        t = tinit.Bilinear()(torch.Generator().manual_seed(0), shape, torch.float32, "cpu")
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="4-D"):
        tinit.Bilinear()(None, (3, 3), torch.float32, "cpu")


@pytest.mark.parametrize("kind, kw", [
    ("Uniform", dict(low=-0.5, high=1.5)),
    ("TruncatedNormal", dict(loc=0.3, scale=2.0)),
])
def test_random_initializers_match_jax_distribution(kind, kw):
    shape = (200_000,)
    j = np.asarray(getattr(jinit, kind)(**kw)(jax.random.PRNGKey(0), shape, jnp.float32))
    t = getattr(tinit, kind)(**kw)(torch.Generator().manual_seed(0), shape, torch.float32,
                                   "cpu").numpy()
    assert t.dtype == np.float32 and t.shape == j.shape
    lo, hi = (kw["low"], kw["high"]) if kind == "Uniform" else \
        (kw["loc"] - 2 * kw["scale"], kw["loc"] + 2 * kw["scale"])
    for a in (j, t):
        assert a.min() >= lo and a.max() <= hi
    spread = hi - lo
    np.testing.assert_allclose(t.mean(), j.mean(), atol=0.01 * spread)
    np.testing.assert_allclose(t.std(), j.std(), rtol=0.01)


def test_initializer_aliases_and_init_on_cpu():
    for alias in ("Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier", "MSRA",
                  "Bilinear"):
        assert getattr(tinit, alias + "Initializer") is getattr(tinit, alias)
        assert hasattr(jinit, alias + "Initializer")
    for mod in (jinit, tinit):
        assert not mod.force_init_on_cpu()
        with mod.init_on_cpu():
            assert mod.force_init_on_cpu()
        assert not mod.force_init_on_cpu()


# -- framework.WeightNormParamAttr ----------------------------------------------
@pytest.mark.parametrize("dim", [1, 0, None], ids=["dim1", "dim0", "global"])
def test_weight_norm_param_attr_matches_jax(dim):
    """fc through a WeightNormParamAttr: the same (v, g) parameters, and on
    the JAX init's values the same loss and gradients; the effective
    weight's norm over the kept dim equals g."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)

    def net(pkg, mean):
        def f(x, y):
            pred = pkg.layers.fc(x, size=4, param_attr=pkg.WeightNormParamAttr(dim=dim),
                                 bias_attr=False)
            return mean((pred - y) ** 2)
        return f

    jmodel = jpt.build(net(jpt, jnp.mean))
    tmodel = pt.build(net(pt, torch.mean))
    jvars = jmodel.init(0, x, y)
    tvars = tmodel.init(0, torch.from_numpy(x), torch.from_numpy(y), device="cpu")
    assert {k: tuple(v.shape) for k, v in tvars.params.items()} == \
        {k: tuple(v.shape) for k, v in jvars.params.items()}
    assert any(k.endswith("w_v") for k in tvars.params)
    assert any(k.endswith("w_g") for k in tvars.params)

    def jloss(params):
        return jmodel.apply(jvars._replace(params=params), x, y)[0]

    jl, jg = jax.value_and_grad(jloss)(jvars.params)
    tparams = {k: torch.tensor(np.asarray(v), requires_grad=True)
               for k, v in jvars.params.items()}
    tl, _ = tmodel.apply(tvars._replace(params=tparams), torch.from_numpy(x),
                         torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for k, g in jg.items():
        np.testing.assert_allclose(tparams[k].grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    v = [t for k, t in tparams.items() if k.endswith("w_v")][0].detach().numpy()
    g = [t for k, t in tparams.items() if k.endswith("w_g")][0].detach().numpy()
    axes = tuple(a for a in range(2) if a != dim) if dim is not None else (0, 1)
    w = (g if dim is None else np.expand_dims(g, axes)) * v / \
        np.sqrt((v * v).sum(axis=axes, keepdims=True))
    np.testing.assert_allclose(np.sqrt((w * w).sum(axis=axes)), np.abs(g), rtol=1e-5)


# -- core.dtypes / core.profiler --------------------------------------------------
def test_dtype_policy_matches_jax():
    for name in ("bool", "int8", "uint8", "int16", "int32", "int64", "float16", "bfloat16",
                 "float32", "float64"):
        assert tdtypes.is_floating(name) == bool(jdtypes.is_floating(name)), name
    assert tdtypes.FP32.compute_dtype == torch.float32 and tdtypes.FP32.param_dtype == torch.float32
    assert tdtypes.MIXED_BF16.compute_dtype == torch.bfloat16
    assert str(jdtypes.MIXED_BF16.compute_dtype) == "bfloat16"
    x = torch.ones(3)
    assert tdtypes.MIXED_BF16.cast_to_compute(x).dtype == torch.bfloat16
    assert tdtypes.MIXED_BF16.cast_to_compute(torch.ones(3, dtype=torch.int32)).dtype == torch.int32
    saved_t, saved_j = tconfig.flags().use_bf16_compute, jconfig.flags().use_bf16_compute
    try:
        for on in (False, True):
            tconfig.set_flags(use_bf16_compute=on)
            jconfig.set_flags(use_bf16_compute=on)
            assert (tdtypes.default_policy() is tdtypes.MIXED_BF16) == on
            assert (jdtypes.default_policy() is jdtypes.MIXED_BF16) == on
            assert tdtypes.compute_dtype() == tdtypes.default_policy().compute_dtype
    finally:
        tconfig.set_flags(use_bf16_compute=saved_t)
        jconfig.set_flags(use_bf16_compute=saved_j)


def test_cuda_profiler_runs_the_block(tmp_path):
    from paddle_tpu_torch.core import profiler as tprof

    ran = []
    if torch.cuda.is_available():
        with tprof.cuda_profiler(str(tmp_path)):
            ran.append(1)
    else:  # no CUDA runtime: warns and traces with torch.profiler, as the JAX package does
        with pytest.warns(UserWarning, match="no CUDA runtime"):
            with tprof.cuda_profiler(str(tmp_path)):
                ran.append(1)
        assert os.path.exists(tmp_path / "trace.chrome.json")
    assert ran == [1]


def test_cost_flops_and_executable_memory():
    from paddle_tpu_torch import tracing
    from paddle_tpu_torch.observability import mfu

    a, b = torch.ones(4, 5), torch.ones(5, 6)
    assert mfu.cost_flops(torch.matmul, a, b) == 2 * 4 * 5 * 6
    got = tracing.record_executable_memory("step")
    assert (got is None) == (not torch.cuda.is_available())


# -- keyword names and positional order -------------------------------------------
def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind == p.POSITIONAL_OR_KEYWORD]


@pytest.mark.parametrize("path, upto", [
    ("ops.attention.scaled_dot_product_attention", "window"),
    ("ops.nn.dropout", "upscale_in_train"),
    ("models.transformer_lm.generate", "cache_dtype"),
    ("models.transformer_lm.paged_prefill_chunk", "rng"),
    ("models.transformer_lm.paged_decode_step", "rng"),
])
def test_keywords_and_positions_follow_jax(path, upto):
    mod, fn = path.rsplit(".", 1)
    j = _positional(getattr(importlib.import_module("paddle_tpu." + mod), fn))
    t = _positional(getattr(importlib.import_module("paddle_tpu_torch." + mod), fn))
    assert t[:t.index(upto) + 1] == j[:j.index(upto) + 1]


def test_sdpa_positional_call_binds_as_jax():
    """Positional arguments past ``is_test`` bind as in the JAX function:
    ``dropout_key``, then ``scale`` and ``causal``."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 2, 8, 4).astype(np.float32) for _ in range(3))
    j = jattn.scaled_dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                           None, 0.0, True, None, 0.5, True)
    t = tattn.scaled_dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                           None, 0.0, True, None, 0.5, True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    kw = tattn.scaled_dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                            scale=0.5, causal=True)
    torch.testing.assert_close(t, kw, rtol=0, atol=0)


def test_random_streams_take_the_jax_keywords():
    """``dropout(key=)``, ``scaled_dot_product_attention(dropout_key=)``:
    a ``torch.Generator`` where JAX takes a key; the old names still work,
    with a DeprecationWarning, and draw the same."""
    from paddle_tpu_torch.ops import nn as tnn

    x = torch.ones(64, 64)
    a = tnn.dropout(x, 0.5, False, torch.Generator().manual_seed(1))
    b = tnn.dropout(x, 0.5, key=torch.Generator().manual_seed(1))
    with pytest.warns(DeprecationWarning, match="key="):
        c = tnn.dropout(x, 0.5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.equal(a, c) and 0 < int((a == 0).sum()) < 64 * 64
    with pytest.raises(TypeError, match="not both"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            tnn.dropout(x, 0.5, key=torch.Generator(), generator=torch.Generator())
    q = torch.randn(1, 2, 8, 4, generator=torch.Generator().manual_seed(0))
    d1 = tattn.scaled_dot_product_attention(q, q, q, None, 0.3, False,
                                            torch.Generator().manual_seed(2))
    with pytest.warns(DeprecationWarning, match="dropout_key="):
        d2 = tattn.scaled_dot_product_attention(q, q, q, dropout_rate=0.3, is_test=False,
                                                dropout_generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)


def test_generate_takes_rng():
    from paddle_tpu_torch import models as tmodels
    from paddle_tpu_torch.models import transformer_lm as tlm

    spec = tmodels.get_model("transformer_lm", device="cpu", seq_len=16, vocab=64, d_model=32,
                             d_inner=64, num_heads=4, n_layers=1)
    cfg = spec.extra["cfg"]
    prompt = torch.from_numpy(np.random.RandomState(0).randint(1, 64, size=(2, 8)).astype(np.int32))
    params = spec.model.init(0, prompt, prompt, device="cpu")
    a = tlm.generate(params, prompt, 4, cfg, 0.8, torch.Generator().manual_seed(5), device="cpu")
    b = tlm.generate(params, prompt, 4, cfg, temperature=0.8, rng=torch.Generator().manual_seed(5),
                     device="cpu")
    with pytest.warns(DeprecationWarning, match="rng="):
        c = tlm.generate(params, prompt, 4, cfg, temperature=0.8,
                         generator=torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(a, b) and torch.equal(a, c)


def test_mnist_synth_batch_equals_jax():
    from paddle_tpu.models import mnist as jmnist
    from paddle_tpu_torch.models import mnist as tmnist

    j = jmnist.synth_batch(4, np.random.RandomState(9))
    t = tmnist.synth_batch(4, np.random.RandomState(9), device="cpu")
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))

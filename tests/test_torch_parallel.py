"""The port's ``parallel`` package against the JAX package's, on the CPU:
the mesh arithmetic and the sharding spec functions on the same inputs,
each collective on two gloo ranks against the JAX package's under
``jax.shard_map`` on two devices (values and gradients), ``pad_batch``,
``batch_divisible`` and the validation errors (the counterparts of
``tests/test_parallel_extensions.py:344,374,901``), a one-rank
``DataParallel`` against ``minimize``'s step, ``parse_cluster_env`` and
``DistributeTranspiler`` (``tests/test_transpiler.py:156,173``), and the
refusals of what is not ported (model-parallel specs, batch specs over
other axes than ``data`` and ``seq``, ``resize``).

Tolerances: collectives move f32 values and sum two of them, so values and
gradients are held at rtol 1e-6; a one-rank ``DataParallel`` runs the very
operations of the direct step, so it is held bit for bit.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import paddle_tpu_torch as pt
import torch_parallel_cases as cases
from paddle_tpu.parallel import collective as jcoll
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import sharding as jsharding
from paddle_tpu.transpiler.distributed import parse_cluster_env as jparse_cluster_env
from paddle_tpu_torch import parallel
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.framework import ParamAttr
from paddle_tpu_torch.parallel import DataParallel, P, launch, mesh as tmesh, sharding
from paddle_tpu_torch.transpiler import DistributeTranspiler, parse_cluster_env


# ---- the mesh ----------------------------------------------------------------
@pytest.mark.parametrize("axes, n", [
    (dict(data=-1), 8), (dict(data=2, model=4), 8), (dict(data=-1, model=2), 8),
    (dict(model=2, data=-1), 6), (dict(data=1), 1), (dict(data=2, seq=2, model=2), 8),
])
def test_make_mesh_matches_jax(axes, n):
    tm = tmesh.make_mesh(dict(axes), devices=list(range(n)))
    jm = jmesh.make_mesh(dict(axes), devices=jax.devices()[:n])
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    np.testing.assert_array_equal(tm.devices, np.vectorize(lambda d: d.id)(jm.devices))
    assert sharding.mesh_axis_sizes(tm) == jsharding.mesh_axis_sizes(jm)


@pytest.mark.parametrize("axes, n, match", [
    ({}, 8, "at least one axis"),
    (dict(data=-1, model=-1), 8, "only one axis"),
    (dict(data=-1, model=3), 8, "not divisible"),
    (dict(data=2, model=2), 8, "mesh wants 4 devices"),
])
def test_make_mesh_errors_match_jax(axes, n, match):
    with pytest.raises(EnforceError, match=match):
        tmesh.make_mesh(dict(axes), devices=list(range(n)))
    with pytest.raises(Exception, match=match):
        jmesh.make_mesh(dict(axes), devices=jax.devices()[:n])


def test_partition_tp_submesh_and_remesh_match_jax():
    devs = jax.devices()
    for tp in (1, 2, 3, 8):
        got = tmesh.partition_devices(tp, list(range(8)))
        want = jmesh.partition_devices(tp, devs)
        assert got == [tuple(d.id for d in g) for g in want]
    assert tmesh.tp_submesh([4, 5]).shape == dict(jmesh.tp_submesh(devs[4:6]).shape)
    m = tmesh.make_mesh(data=4, model=2, devices=list(range(8)))
    jm = jmesh.make_mesh(data=4, model=2, devices=devs)
    for k in (6, 4, 2):
        assert tmesh.remesh(m, list(range(k))).shape == dict(jmesh.remesh(jm, devs[:k]).shape)
    with pytest.raises(EnforceError, match="not divisible"):
        tmesh.remesh(m, list(range(7)))


def test_default_mesh_without_a_process_group_is_one_rank():
    m = tmesh.default_mesh()
    assert m.shape == {"data": 1} and m.size == 1
    assert m.group("data") is None and m.axis_index("data") == 0
    x = torch.arange(4.0)
    with m:
        assert torch.equal(parallel.collective.all_reduce(x, "data"), x)
        assert torch.equal(parallel.collective.all_gather(x, "data"), x)
        assert parallel.collective.axis_size("data") == 1


# ---- the sharding spec functions ----------------------------------------------
RULES = [("*/q/w", ("P", None, "model")), ("emb/*", ("P", "model", None)),
         ("*", ("P",))]


def _specs(rules, make):
    return [(pat, make(*spec[1:])) for pat, spec in rules]


@pytest.mark.parametrize("name, ndim", [
    ("layer_0/q/w", 2), ("emb/word", 2), ("ln/scale", 1), ("layer_0/q/w", None)])
def test_spec_for_matches_jax(name, ndim):
    got = sharding.spec_for(name, _specs(RULES, P), ndim=ndim)
    want = jsharding.spec_for(name, _specs(RULES, JP), ndim=ndim)
    assert tuple(got) == tuple(want)


def test_spec_for_rank_mismatch_raises_in_both():
    rules = [("b", ("P", None, "model"))]
    with pytest.raises(EnforceError, match="rank 1"):
        sharding.spec_for("b", _specs(rules, P), ndim=1)
    with pytest.raises(Exception, match="rank 1"):
        jsharding.spec_for("b", _specs(rules, JP), ndim=1)


@pytest.mark.parametrize("spec, shape", [
    ((None, "model"), (6, 8)), (("model", None), (6, 8)), (("data", "model"), (8, 6)),
    (("seq",), (4,)), (("model",), (6, 2, 2)), ((), (3,))])
def test_degraded_dims_and_degrade_spec_match_jax(spec, shape):
    sizes = {"data": 2, "model": 4}
    assert sharding.degraded_dims(sizes, P(*spec), shape) == \
        jsharding.degraded_dims(sizes, JP(*spec), shape)
    tm = tmesh.make_mesh(data=2, model=4, devices=list(range(8)))
    jm = jmesh.make_mesh(data=2, model=4, devices=jax.devices())
    got = sharding.degrade_spec(tm, P(*spec), shape, quiet=True)
    assert tuple(got) == tuple(jsharding.degrade_spec(jm, JP(*spec), shape, quiet=True))


def test_batch_sharding_and_replicated():
    m = tmesh.make_mesh(data=2, devices=[0, 1])
    assert tuple(sharding.batch_sharding(m, ndim=3).spec) == ("data", None, None)
    assert tuple(sharding.replicated(m).spec) == ()


# ---- collectives on two ranks vs shard_map ------------------------------------
def _jax_collectives(xs, ws):
    """Each collective of the JAX package under shard_map on 2 devices:
    per-rank values and per-rank gradients of sum(w * value)."""
    mesh = jmesh.make_mesh(data=2, devices=jax.devices()[:2])
    fns = {
        "psum": lambda x: jcoll.all_reduce(x, "data", "sum"),
        "pmean": lambda x: jcoll.all_reduce(x, "data", "mean"),
        "pmax": lambda x: jcoll.all_reduce(x, "data", "max"),
        "pmin": lambda x: jcoll.all_reduce(x, "data", "min"),
        "all_gather": lambda x: jcoll.all_gather(x, "data", axis=0, tiled=True),
        "all_gather_stacked": lambda x: jcoll.all_gather(x, "data", axis=1, tiled=False),
        "reduce_scatter": lambda x: jcoll.reduce_scatter(x, "data", scatter_dimension=1),
        "broadcast": lambda x: jcoll.broadcast(x, "data", root=1),
        "ppermute": lambda x: jcoll.ppermute(x, "data", [(0, 1)]),
        "ring_shift": lambda x: jcoll.ring_shift(x, "data", 1),
    }
    X = jnp.asarray(xs.reshape((-1,) + xs.shape[2:]))
    out = {}
    for name, f in fns.items():
        g = jax.shard_map(f, mesh=mesh, in_specs=JP("data"), out_specs=JP("data"))
        y = np.asarray(g(X))
        vals = np.split(y, 2)
        grads = None
        if name not in ("pmax", "pmin"):
            W = jnp.asarray(np.concatenate(ws[name]))
            grads = np.split(np.asarray(jax.grad(lambda X: jnp.sum(W * g(X)))(X)), 2)
        out[name] = (vals, grads)
    return out


COLLECTIVES = ("psum", "pmean", "pmax", "pmin", "all_gather", "all_gather_stacked",
               "reduce_scatter", "broadcast", "ppermute", "ring_shift")


@pytest.fixture(scope="module")
def collective_runs():
    rng = np.random.RandomState(0)
    xs = rng.randn(2, 4, 6).astype(np.float32)
    shapes = {"psum": (4, 6), "pmean": (4, 6), "all_gather": (8, 6),
              "all_gather_stacked": (4, 2, 6), "reduce_scatter": (4, 3), "broadcast": (4, 6),
              "ppermute": (4, 6), "ring_shift": (4, 6)}
    ws = {k: rng.randn(2, *s).astype(np.float32) for k, s in shapes.items()}
    return launch.spawn(cases.collectives, 2, args=(xs, ws), device="cpu"), _jax_collectives(xs, ws)


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_shard_map(collective_runs, name):
    ranks, want = collective_runs
    vals, grads = want[name]
    for r in range(2):
        value, grad = ranks[r][name]
        np.testing.assert_allclose(value, vals[r], rtol=1e-6, atol=1e-6, err_msg=name)
        if grads is None:
            assert grad is None  # max and min carry no gradient, as in JAX
        else:
            np.testing.assert_allclose(grad, grads[r], rtol=1e-6, atol=1e-6, err_msg=name)


def test_axis_index_size_put_batch_and_transpiler_mesh(collective_runs):
    ranks, _ = collective_runs
    for r in range(2):
        assert ranks[r]["axis"] == (r, 2)
        index, size, total = ranks[r]["model_axis"]
        assert (index, size) == (r, 2) and total.tolist() == [2.0, 2.0]
        x, y = ranks[r]["put_batch"]
        assert x[:, 0].tolist() == list(range(4 * r, 4 * r + 4)) and y.tolist() == x[:, 0].tolist()
        data_only, with_model, chief = ranks[r]["trainer_mesh"]
        assert data_only == {"data": 2} and with_model == {"data": 1, "model": 2}
        assert chief == (r == 0)


# ---- DataParallel on one process ---------------------------------------------
def _mlp():
    return pt.build(cases.mlp_net(pt.layers, pt.ops, torch.mean), name="mlp")


def _batch(n=8, seed=0):
    r = np.random.RandomState(seed)
    return r.randn(n, 3).astype(np.float32), r.randn(n).astype(np.float32)


def test_pad_batch_mask_and_repeat():
    """``pad_batch`` pads a ragged batch to the shard multiple by repeating
    the last real row, with a mask covering exactly the real rows."""
    dp = DataParallel(_mlp(), pt.optimizer.SGD(1e-2), device="cpu",
                      mesh=tmesh.make_mesh(data=8, devices=list(range(8))))
    r = np.random.RandomState(0)
    x = r.rand(13, 4).astype(np.float32)
    y = r.randint(0, 5, size=(13, 1)).astype(np.int64)
    (px, py), mask = dp.pad_batch(x, y)
    assert px.shape == (16, 4) and py.shape == (16, 1)
    assert mask.tolist() == [1.0] * 13 + [0.0] * 3
    np.testing.assert_array_equal(px[13:], np.repeat(x[-1:], 3, axis=0))
    (px, _), mask = dp.pad_batch(x, y, to=24)
    assert px.shape == (24, 4) and mask.sum() == 13
    (qx, _), mask = dp.pad_batch(x[:8], y[:8])
    assert qx.shape == (8, 4) and mask.sum() == 8
    (tx, _), mask = dp.pad_batch(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(tx[13:], torch.from_numpy(x[-1:]).expand(3, 4))
    with pytest.raises(EnforceError, match="divisible"):
        dp.pad_batch(x, y, to=15)
    with pytest.raises(EnforceError, match="share the leading dim"):
        dp.pad_batch(x, y[:4])


def test_batch_divisible_leading_multiple_and_validation():
    dp = DataParallel(_mlp(), pt.optimizer.SGD(1e-2), device="cpu",
                      mesh=tmesh.make_mesh(data=4, devices=list(range(4))),
                      batch_specs=(P("data"), P()))
    side = np.zeros((3,), np.float32)  # replicated: never vetoes
    assert dp.batch_divisible(np.zeros((8, 2)), side)
    assert not dp.batch_divisible(np.zeros((6, 2)), side)
    assert dp.leading_multiple(np.zeros((8, 2)), side) == 4
    with pytest.raises(EnforceError, match="not divisible by mesh axes"):
        dp.put_batch(np.zeros((6, 2), np.float32), side)
    with pytest.raises(EnforceError, match="batch_specs has 2 entries for 1"):
        dp.put_batch(np.zeros((8, 2), np.float32))


@pytest.fixture
def one_rank_group(tmp_path):
    """A real one-rank gloo group (a FileStore under tmp_path), destroyed
    after the test."""
    tmesh.initialize_distributed(init_method=f"file://{tmp_path}/store", num_processes=1,
                                 process_id=0, device="cpu")
    yield
    tmesh.shutdown_distributed()


@pytest.mark.parametrize("group", [False, True], ids=["no_group", "gloo_group"])
@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero1"])
def test_one_rank_dp_step_equals_minimize_bit_for_bit(request, group, zero):
    """At one rank the data-parallel step is the direct step: the same loss,
    parameters and slots, bit for bit (``tests/test_parallel_extensions.py:374``'s
    trajectory, here exact), with and without ZeRO-1 and a process group."""
    if group:
        request.getfixturevalue("one_rank_group")
    model, (x, y) = _mlp(), _batch()
    opt = pt.optimizer.Adam(1e-2)
    v0 = model.init(0, torch.from_numpy(x), torch.from_numpy(y), device="cpu")
    dp = DataParallel(model, pt.optimizer.Adam(1e-2), device="cpu", zero_shard_optimizer=zero)
    v, o = dp.init(0, x, y, variables=v0)
    rv, ro = v0, opt.create_state(v0.params)
    step = opt.minimize(model)
    for _ in range(4):
        out = dp.step(v, o, *dp.put_batch(x, y))
        ref = step(rv, ro, torch.from_numpy(x), torch.from_numpy(y))
        assert float(out.loss) == float(ref.loss)
        v, o, rv, ro = out.variables, out.opt_state, ref.variables, ref.opt_state
        for k in rv.params:
            assert torch.equal(v.params[k], rv.params[k]), k
            for s in ro.slots:
                assert torch.equal(o.slots[s][k], ro.slots[s][k]), (s, k)
    assert dp.num_devices == 1 and out.outputs[1].shape == (8, 1)


# ---- what is not ported ---------------------------------------------------------
def test_model_parallel_mesh_and_specs_raise():
    """Every mesh and spec the JAX package's GSPMD runs is taken: ``model``
    and ``pipe`` axes (``test_torch_tensor_parallel.py``,
    ``test_torch_pipeline.py``), their compositions
    (``test_torch_composed_parallel.py``), and the meshes and specs once
    refused — a ``tp`` axis, ``model`` beside ``expert``, ``pipe`` beside
    ``seq`` or ``expert``, batch specs over other axes and dims, and a
    parameter split over any axis (they step on their ranks in
    ``test_torch_any_mesh.py``); a norm clip on a ``model`` axis reads the
    whole gradients' norms. What raises is what the JAX package refuses,
    with its message: a batch spec naming an axis the mesh lacks, or one
    axis twice."""
    for axes in (dict(data=1, model=2), dict(data=1, pipe=2), dict(data=1, model=2, seq=2),
                 dict(data=1, pipe=2, model=2), dict(data=1, tp=2), dict(data=1, model=2, expert=2),
                 dict(data=1, pipe=2, expert=2), dict(data=1, pipe=2, seq=2)):
        n = int(np.prod(list(axes.values())))
        dp = DataParallel(_mlp(), pt.optimizer.SGD(1e-2), device="cpu",
                          mesh=tmesh.make_mesh(**axes, devices=list(range(n))))
        assert dp.num_devices == n and dp._token_axes == ("data",)
    tp_mlp = pt.build(lambda x: pt.layers.fc(x, 4, param_attr=ParamAttr(sharding=(None, "model"))),
                      name="tp")
    tp_mlp.init(0, torch.zeros(2, 4), device="cpu")
    clipped = DataParallel(tp_mlp, pt.optimizer.SGD(
        1e-2, grad_clip=pt.clip.GradientClipByGlobalNorm(1.0)), device="cpu",
        mesh=tmesh.make_mesh(data=1, model=2, devices=[0, 1]))
    assert clipped._apply_fn() == clipped._apply
    with pytest.raises(ValueError, match=r"Resource axis: seq of PartitionSpec\('data', 'seq'\) "
                                         r"is not found in mesh: \('data',\)"):
        DataParallel(_mlp(), pt.optimizer.SGD(1e-2), device="cpu",
                     batch_specs=(P("data", "seq"), P()))
    with pytest.raises(ValueError, match="has duplicate entries for `data`"):
        DataParallel(_mlp(), pt.optimizer.SGD(1e-2), device="cpu",
                     batch_specs=(P(("data", "data")),))
    # a split over another dim is gathered whole at the step's entry: replicas
    dp = DataParallel(_mlp(), pt.optimizer.SGD(1e-2), device="cpu", batch_specs=(P(None, "data"),))
    assert dp._token_axes == ()
    # rows over several axes, and over an axis the layers consume (gathered)
    mex = tmesh.make_mesh(data=1, model=2, expert=2, devices=[0, 1, 2, 3])
    for specs, want in (((P(("data", "expert")), P(("data", "expert"))), ("data", "expert")),
                        ((P(("data", "model")), P("data")), ("data",)),
                        ((P(("expert", "data")), P(("data", "expert"))), ("expert", "data"))):
        dp = DataParallel(_mlp(), pt.optimizer.SGD(1e-2), device="cpu", mesh=mex,
                          batch_specs=specs)
        assert dp._token_axes == want and dp.leading_multiple(*_batch()) == 2
    seq_mesh = tmesh.make_mesh(data=1, seq=1, devices=[0])
    dp = DataParallel(_mlp(), pt.optimizer.SGD(1e-2), device="cpu", mesh=seq_mesh,
                      batch_specs=(P("data", "seq"), P("data")))
    assert dp._token_axes == ("data", "seq")
    m = tmesh.make_mesh(data=2, devices=[0, 1])
    model = pt.build(lambda x: pt.layers.fc(x, 4, param_attr=ParamAttr(sharding=("data", None))),
                     name="fsdp")
    v = model.init(0, torch.zeros(2, 4), device="cpu")
    specs = sharding.param_shardings(m, model.param_info, v.params)
    assert specs["fc/w"].spec == P("data", None)
    assert sharding.split_blocks(specs) == ({}, {"fc/w": [(0, "data")]})
    # a tensor-parallel spec on a data-only mesh degrades to replicated
    tp = pt.build(lambda x: pt.layers.fc(x, 4, param_attr=ParamAttr(sharding=(None, "model"))),
                  name="tp")
    tv = tp.init(0, torch.zeros(2, 4), device="cpu")
    assert all(a is None for s in sharding.param_shardings(m, tp.param_info, tv.params).values()
               for a in s.spec)
    # on a model axis the column spec holds (the bias, unannotated, stays
    # replicated), and a dim the axis does not divide degrades
    mm = tmesh.make_mesh(data=1, model=2, devices=[0, 1])
    specs = sharding.param_shardings(mm, tp.param_info, tv.params)
    assert specs["fc/w"].spec == P(None, "model") and specs["fc/b"].spec == P()
    odd = pt.build(lambda x: pt.layers.fc(x, 3, param_attr=ParamAttr(sharding=(None, "model"))),
                   name="odd")
    ov = odd.init(0, torch.zeros(2, 4), device="cpu")
    assert sharding.param_shardings(mm, odd.param_info, ov.params)["fc/w"].spec == P(None, None)


def test_resize_pipeline_and_moe_raise():
    """``resize`` still raises naming ROADMAP.md; ZeRO-1 on an ``expert``
    axis is taken (``test_torch_composed_parallel.py``); the pipeline names
    (``parallel/pipeline.py``) and the MoE names (``parallel/moe.py``) are
    ported."""
    dp = DataParallel(_mlp(), pt.optimizer.SGD(1e-2), device="cpu")
    with pytest.raises(NotImplementedError, match="(?s)elastic.*ROADMAP.md"):
        dp.resize([0])
    zero = DataParallel(_mlp(), pt.optimizer.SGD(1e-2), device="cpu", zero_shard_optimizer=True,
                        mesh=tmesh.make_mesh(data=1, expert=2, devices=[0, 1]))
    assert zero.zero_shard_optimizer and zero.num_devices == 2
    from paddle_tpu_torch.parallel import pipeline

    assert (parallel.pipeline_apply, parallel.stack_stage_params,
            parallel.split_microbatches) == (pipeline.pipeline_apply, pipeline.stack_stage_params,
                                             pipeline.split_microbatches)
    mbs = parallel.split_microbatches(torch.arange(12.0).reshape(6, 2), 3)
    assert mbs.shape == (3, 2, 2)
    with pytest.raises(EnforceError, match="not divisible into 4 microbatches"):
        parallel.split_microbatches(torch.zeros(6, 2), 4)
    stacked = parallel.stack_stage_params([{"w": torch.zeros(2)}, {"w": torch.ones(2)}])
    assert stacked["w"].tolist() == [[0.0, 0.0], [1.0, 1.0]]
    from paddle_tpu_torch.parallel import moe

    assert (parallel.moe_ffn, parallel.switch_gate, parallel.top2_gate, parallel.MoEOutput) == (
        moe.moe_ffn, moe.switch_gate, moe.top2_gate, moe.MoEOutput)


def test_dataparallel_on_cuda_needs_a_card():
    """DataParallel, initialize_distributed and spawn default to CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataParallel(_mlp(), pt.optimizer.SGD(1e-2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.initialize_distributed(init_method="file:///nonexistent/store", num_processes=1,
                                     process_id=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # before any rank starts
        launch.spawn(cases.collectives, 2, args=(None, None))


# ---- the distributed transpiler ------------------------------------------------
def test_parse_cluster_env_matches_jax():
    env = {"PADDLE_TRAINER_ID": "2", "PADDLE_TRAINERS": "4",
           "PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:7164,10.0.0.2:7164"}
    role, jrole = parse_cluster_env(env), jparse_cluster_env(env)
    assert (role.trainer_id, role.num_trainers, role.coordinator, role.role, role.is_chief) == (
        jrole.trainer_id, jrole.num_trainers, jrole.coordinator, jrole.role, jrole.is_chief)
    assert role.trainer_id == 2 and role.coordinator == "10.0.0.1:7164" and not role.is_chief
    with pytest.raises(EnforceError, match="parameter-server"):
        parse_cluster_env({"PADDLE_TRAINING_ROLE": "PSERVER"})


def test_distribute_transpiler_single_process_mesh():
    t = DistributeTranspiler()
    t.transpile(trainer_id=0, trainers=1)
    assert t.trainer_mesh().shape == {"data": 1}
    assert t.get_trainer_program() is None
    with pytest.raises(EnforceError, match="1 devices not divisible by 2"):
        t.trainer_mesh(model_axis=2)
    with pytest.raises(NotImplementedError):
        t.get_pserver_program()
    with pytest.raises(EnforceError, match="pserver"):
        t.transpile(pservers="127.0.0.1:6174")

"""Rank bodies of the port's data-parallel tests (``test_torch_parallel.py``,
``test_torch_data_parallel.py``, ``test_torch_checkpoint_sharded.py``,
``test_torch_trainer_parallel.py``).

Each function runs as one rank of a gloo group on the CPU, spawned by
``paddle_tpu_torch.parallel.launch.spawn``: it imports only numpy, torch
and the port (never JAX), takes numpy inputs and returns numpy results,
which the test compares with the JAX package's in the parent process.
The model configurations live here so both sides build the same models.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: its share of the cores)
import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import checkpoint_sharded as cks
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.framework import Variables
from paddle_tpu_torch.parallel import DataParallel, P, collective, make_mesh

STEPS = 3
LM = dict(seq_len=16, vocab=64, d_model=32, d_inner=64, num_heads=4, n_layers=2)
NMT = dict(seq_len=8, src_vocab=32, trg_vocab=32, d_model=32, d_inner=64, num_heads=4,
           n_layers=1, max_len=16, attn_dropout=0.0, relu_dropout=0.0, residual_dropout=0.0)
RESNET = dict(dataset="cifar10", depth=8)
MLP_LR = 1e-2


def mlp_net(layers, ops, mean):
    """The MLP of the tests, for either package's ``layers``/``ops``."""

    def net(x, y):
        h = layers.fc(x, 8, act="relu", name="h")
        p = layers.fc(h, 1, name="o")
        return mean(ops.nn.square_error_cost(p[:, 0], y)), p

    return net


def bn_net(layers, ops, mean):
    """fc -> batch_norm -> relu -> fc: BatchNorm's state in the pmap form."""

    def net(x, y):
        h = layers.batch_norm(layers.fc(x, 8, name="h"), act="relu", name="bn")
        p = layers.fc(h, 1, name="o")
        return mean(ops.nn.square_error_cost(p[:, 0], y)), p

    return net


def port_model(name):
    """(model, optimizer factory) of the port for a case name."""
    if name == "mlp":
        return pt.build(mlp_net(pt.layers, pt.ops, torch.mean), name="mlp"), \
            lambda: pt.optimizer.Adam(MLP_LR)
    if name == "bn":
        return pt.build(bn_net(pt.layers, pt.ops, torch.mean), name="bn_net"), \
            lambda: pt.optimizer.Momentum(0.1, momentum=0.9)
    if name in ("lm", "lm_ragged"):
        spec = tmodels.get_model("transformer_lm", device="cpu", **LM)
    elif name == "resnet_bn":
        spec = tmodels.get_model("resnet", device="cpu", **RESNET)
    elif name == "nmt":
        spec = tmodels.get_model("transformer", device="cpu", **NMT)
    else:
        raise ValueError(name)
    return spec.model, spec.optimizer


def tensors(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def numpy_state(variables, opt_state):
    return ({k: t.detach().numpy().copy() for k, t in variables.params.items()},
            {k: t.detach().numpy().copy() for k, t in variables.state.items()},
            {s: {k: t.detach().numpy().copy() for k, t in d.items()}
             for s, d in opt_state.slots.items()})


# -- collectives ------------------------------------------------------------
def collectives(rank, xs, ws):
    """Each collective on ``xs[rank]``: its value and the gradient of
    ``sum(ws[rank] * value)`` with respect to the input."""
    out = {}

    def run(name, fn):
        x = torch.from_numpy(xs[rank].copy()).requires_grad_(True)
        y = fn(x)
        out[name] = [y.detach().numpy()]
        if y.requires_grad:
            w = torch.from_numpy(ws[name][rank].copy())
            (w * y).sum().backward()
            out[name].append(x.grad.numpy())
        else:
            out[name].append(None)

    run("psum", lambda x: collective.all_reduce(x, "data", "sum"))
    run("pmean", lambda x: collective.all_reduce(x, "data", "mean"))
    run("pmax", lambda x: collective.all_reduce(x, "data", "max"))
    run("pmin", lambda x: collective.all_reduce(x, "data", "min"))
    run("all_gather", lambda x: collective.all_gather(x, "data", axis=0, tiled=True))
    run("all_gather_stacked", lambda x: collective.all_gather(x, "data", axis=1, tiled=False))
    run("reduce_scatter", lambda x: collective.reduce_scatter(x, "data", scatter_dimension=1))
    run("broadcast", lambda x: collective.broadcast(x, "data", root=1))
    run("ppermute", lambda x: collective.ppermute(x, "data", [(0, 1)]))
    run("ring_shift", lambda x: collective.ring_shift(x, "data", 1))
    out["axis"] = (collective.axis_index("data"), collective.axis_size("data"))
    # put_batch: rank r takes rows [r*B/N, (r+1)*B/N) of every split arg
    model, opt = port_model("mlp")
    dp = DataParallel(model, opt(), device="cpu")
    rows = dp.put_batch(np.arange(8, dtype=np.float32).reshape(8, 1), np.arange(8))
    out["put_batch"] = [r.numpy() for r in rows]
    from paddle_tpu_torch.transpiler import DistributeTranspiler

    t = DistributeTranspiler().transpile(trainer_id=rank, trainers=2, device="cpu")
    out["trainer_mesh"] = (t.trainer_mesh().shape, t.trainer_mesh(model_axis=2).shape,
                           t.role.is_chief)
    with make_mesh(data=1, model=2):
        out["model_axis"] = (collective.axis_index("model"), collective.axis_size("model"),
                             collective.all_reduce(torch.ones(2), "model").numpy())
    return out


# -- data parallelism -------------------------------------------------------
def dp_models(rank, cases):
    """``cases``: {name: (batch, params, state)}. Three DataParallel steps
    of each; the LM also with ZeRO-1; the MLP's ragged step."""
    out = {}
    for name, (batch, params, state) in cases.items():
        model, opt = port_model(name)
        for zero in ((False, True) if name == "lm" else (False,)):
            dp = DataParallel(model, opt(), device="cpu", zero_shard_optimizer=zero)
            v, o = dp.init(0, *batch, variables=Variables(tensors(params), tensors(state)))
            losses, outputs = [], None
            for _ in range(STEPS):
                res = dp.step(v, o, *batch)
                v, o = res.variables, res.opt_state
                losses.append(float(res.loss))
                outputs = res.outputs
            out[(name, zero)] = dict(
                losses=losses, state=numpy_state(v, o),
                output_shapes=[tuple(t.shape) for t in pt.core.tree.leaves(outputs)
                               if isinstance(t, torch.Tensor)],
                output_loss=float(outputs[0]),
                template=[(lay.shape, lay.window, lay.owner) for lay in pt.core.tree.leaves(
                    dp.state_template(v, o)[1].slots)])
    # a ragged batch (5 rows over 2 ranks) through step_ragged
    batch, params, state = cases["mlp"]
    model, opt = port_model("mlp")
    dp = DataParallel(model, opt(), device="cpu")
    v, o = dp.init(0, *batch, variables=Variables(tensors(params), tensors(state)))
    ragged = tuple(b[:5] for b in batch)
    res = dp.step_ragged(v, o, *ragged)
    out["ragged"] = dict(loss=float(res.loss), divisible=dp.batch_divisible(*ragged),
                         state=numpy_state(res.variables, res.opt_state))
    # batch_outputs: the named outputs are gathered, () keeps this rank's rows
    out["batch_outputs"] = {}
    for named in (None, (1,), ()):
        dp = DataParallel(model, opt(), device="cpu", batch_outputs=named)
        res = dp.step(v, o, *batch)
        out["batch_outputs"][named] = (tuple(res.outputs[1].shape), res.outputs[1].numpy(),
                                       tuple(dp.eval_step(v, *batch)[1].shape))
    try:
        DataParallel(model, opt(), device="cpu", batch_outputs=(0,)).step(v, o, *batch)
    except ValueError as e:
        out["batch_outputs"]["loss_named"] = str(e)
    return out


def minimize_axis(rank, name, batch, params, state):
    """``minimize(axis_name="data")`` on this rank's half of ``batch``."""
    model, opt_fn = port_model(name)
    opt = opt_fn()
    v = Variables(tensors(params), tensors(state))
    o = opt.create_state(v.params)
    k = len(batch[0]) // 2
    local = tuple(torch.from_numpy(b[rank * k:(rank + 1) * k].copy()) for b in batch)
    step = opt.minimize(model, axis_name="data")
    losses = []
    for _ in range(STEPS):
        res = step(v, o, *local)
        v, o = res.variables, res.opt_state
        losses.append(float(res.loss))
    return dict(losses=losses, state=numpy_state(v, o))


# -- sharded checkpoints ----------------------------------------------------
def save_zero_lm(rank, root, batch, params, zero):
    """Two LM steps under DataParallel (ZeRO-1 or not), then a sharded save
    at step 2 in ``root``; returns this rank's state."""
    model, opt = port_model("lm")
    dp = DataParallel(model, opt(), device="cpu", zero_shard_optimizer=zero)
    v, o = dp.init(0, *batch, variables=Variables(tensors(params), {}))
    for _ in range(2):
        res = dp.step(v, o, *batch)
        v, o = res.variables, res.opt_state
    cks.save_sharded(root, (v, o), step=2, template=dp.state_template(v, o))
    return numpy_state(v, o)


def load_zero_lm(rank, root, batch, params, zero):
    """The LM's state restored from ``root`` at this world size (ZeRO-1 or
    not): this rank's leaves and the layout it asked for."""
    model, opt = port_model("lm")
    dp = DataParallel(model, opt(), device="cpu", zero_shard_optimizer=zero)
    v, o = dp.init(0, *batch, variables=Variables(tensors(params), {}))
    (v, o), manifest = cks.load_sharded(root, dp.state_template(v, o))
    return numpy_state(v, o), o.step, manifest["step"]


def windows_save(rank, root, truth):
    """Each rank saves its half of every leaf of ``truth`` by rows (dim 0),
    with the 0-d leaf owned by rank 0 — a 2-rank layout of the JAX test's
    sharded tree."""
    from paddle_tpu_torch.parallel.sharding import LeafLayout

    tree, template = {}, {}
    for k, v in truth.items():
        if v.ndim == 0:
            tree[k] = torch.from_numpy(v.copy())
            template[k] = LeafLayout(v.shape, torch.float32, "cpu", owner=rank == 0)
            continue
        h = v.shape[0] // 2
        tree[k] = torch.from_numpy(v[rank * h:(rank + 1) * h].copy())
        window = [(rank * h, (rank + 1) * h)] + [(0, s) for s in v.shape[1:]]
        template[k] = LeafLayout(v.shape, torch.float32, "cpu", window)
    return cks.save_sharded(root, tree, step=1, template=template)


def windows_load(rank, root, shapes, split_dim):
    """Restore every leaf as this rank's half on ``split_dim`` (whole when
    it does not split)."""
    from paddle_tpu_torch.parallel.sharding import LeafLayout

    template = {}
    for k, shape in shapes.items():
        window = [(0, s) for s in shape]
        if len(shape) > split_dim:
            h = shape[split_dim] // 2
            window[split_dim] = (rank * h, (rank + 1) * h)
        template[k] = LeafLayout(shape, torch.float32, "cpu", window)
    tree, _ = cks.load_sharded(root, template)
    return {k: t.numpy() for k, t in tree.items()}


# -- the Trainer ------------------------------------------------------------
def linreg_net(pkg, mean):
    """Linear regression with constant initial weights, for either package
    (the two packages' random initializers differ; a constant does not)."""

    def model():
        def net(x, y):
            attr = pkg.ParamAttr(initializer=pkg.initializer.Constant(0.1))
            pred = pkg.layers.fc(x, size=1, param_attr=attr)
            return mean(pkg.ops.nn.square_error_cost(pred, y)), pred

        return net

    return model


_linreg = linreg_net(pt, torch.mean)


def linreg_reader(n_batches=4, bs=8, seed=0, tail=0):
    def reader():
        rng = np.random.RandomState(seed)
        w = np.array([[2.0], [-1.0], [0.5], [3.0]], np.float32)
        for i in range(n_batches + (1 if tail else 0)):
            x = rng.randn(tail if i == n_batches else bs, 4).astype(np.float32)
            yield x, x @ w + 0.1

    return reader


def trainer_run(rank, root, kind, kw):
    """The Trainer's parallel path on this rank: ``kind`` "train" (``kw``:
    epochs, n_batches, tail, allow_ragged, adam, prefetch, sharded,
    step_interval, parallel_kwargs) or "evaluate" (one training step, then
    the exact metric over a test set with a ragged tail)."""
    from paddle_tpu_torch.trainer import CheckpointConfig, EndStepEvent, Trainer

    losses = []

    def handler(ev):
        if isinstance(ev, EndStepEvent):
            losses.append(ev.metrics)

    opt = (lambda: pt.optimizer.Adam(0.05)) if kw.get("adam") else (
        lambda: pt.optimizer.SGD(learning_rate=0.1))
    cfg = None
    if root is not None:
        cfg = CheckpointConfig(root, step_interval=kw.get("step_interval", 2),
                               sharded=kw.get("sharded"))
    t = Trainer(_linreg, opt, parallel=True, place="cpu", checkpoint_config=cfg,
                prefetch=kw.get("prefetch", False), parallel_kwargs=kw.get("parallel_kwargs"))
    if kind == "evaluate":
        t.train(num_epochs=1, reader=linreg_reader(n_batches=1, bs=8))
        metric = t.evaluate(linreg_reader(n_batches=3, bs=8, tail=5),
                            lambda out, x, y: out[1][:, 0].numpy() > np.asarray(y)[:, 0])
        return dict(metric=metric, state=numpy_state(t.variables, t.opt_state))
    t.train(num_epochs=kw.get("epochs", 2), event_handler=handler,
            reader=linreg_reader(n_batches=kw.get("n_batches", 4), tail=kw.get("tail", 0)),
            allow_ragged=kw.get("allow_ragged", False))
    return dict(losses=losses, step=t.global_step, epoch=t.epoch, devices=t._dp.num_devices,
                state=numpy_state(t.variables, t.opt_state))


# -- sequence and expert parallelism ------------------------------------------
# (test_torch_seq_parallel.py, test_torch_moe.py)
SP_LM = dict(seq_len=32, vocab=64, d_model=32, d_inner=64, num_heads=4, n_layers=1, max_len=64)
MOE_LM = dict(seq_len=16, vocab=128, d_model=32, d_inner=64, num_heads=4, n_layers=2,
              max_len=32, moe_experts=4)


def _traced(fn, arrays, w):
    """``fn`` on tensors of ``arrays`` (float ones require grad): the value
    and the gradients of ``sum(w * value)``."""
    ts = [torch.from_numpy(np.array(a)) for a in arrays]
    for t in ts:
        if t.is_floating_point():
            t.requires_grad_(True)
    y = fn(*ts)
    grads = torch.autograd.grad((torch.from_numpy(np.array(w)) * y).sum(),
                                [t for t in ts if t.requires_grad])
    return [y.detach().numpy()] + [g.numpy() for g in grads]


def sp_exchanges(rank, xs, ws):
    """``ppermute`` and ``all_to_all`` on ``xs[rank]`` over the default
    (data) axis: values and gradients of ``sum(ws[name][rank] * value)``,
    the routes they took, and how often ``dist.all_gather`` was called."""
    import torch.distributed as dist

    cases = {
        "ring": lambda x: collective.ppermute(x, "data", [(0, 1), (1, 0)]),
        "one_pair": lambda x: collective.ppermute(x, "data", [(1, 0)]),
        "a2a_0_1": lambda x: collective.all_to_all(x, "data", 0, 1),
        "a2a_1_0": lambda x: collective.all_to_all(x, "data", 1, 0),
        "a2a_2_2": lambda x: collective.all_to_all(x, "data", 2, 2),
        "a2a_untiled": lambda x: collective.all_to_all(x, "data", 0, 2, tiled=False),
    }
    calls, real = [], dist.all_gather

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    collective.reset_routes()
    dist.all_gather = spy
    try:
        out = {name: _traced(fn, [xs[rank]], ws[name][rank]) for name, fn in cases.items()}
    finally:
        dist.all_gather = real
    out["all_gather_calls"] = len(calls)
    out["routes"] = collective.routes_taken()
    return out


def sp_attention(rank, axes, cases):
    """``ring_attention_sharded`` / ``ulysses_attention_sharded`` on a mesh
    of ``axes`` over GLOBAL inputs: per case, the value and the gradients
    of ``sum(w * out)`` in q, k, v (or the error a refused case raises)."""
    from paddle_tpu_torch.ops.ring_attention import ring_attention_sharded
    from paddle_tpu_torch.ops.ulysses import ulysses_attention_sharded

    mesh = make_mesh(**axes)
    fns = {"ring": ring_attention_sharded, "ulysses": ulysses_attention_sharded}
    out = {}
    for name, (kind, routes, _, q, k, v, w, kv_len) in cases.items():
        lens = None if kv_len is None else torch.from_numpy(kv_len)
        out[name] = []
        for kw in routes:
            try:
                out[name].append(_traced(
                    lambda a, b, c: fns[kind](a, b, c, mesh, kv_len=lens, **kw), [q, k, v], w))
            except Exception as e:  # the refusals: reported, held by the test
                out[name].append(f"{type(e).__name__}: {e}")
    return out


def _lm_spec(kw, mesh):
    """The port's LM for ``kw`` (``seq_mode``: "ring" or "ulysses" over
    ``mesh``; ``flash``: the flash attention flag), on the CPU."""
    from paddle_tpu_torch.core.config import set_flags

    kw = dict(kw)
    set_flags(use_flash_attention=kw.pop("flash", False))
    mode = kw.pop("seq_mode", None)
    if mode is not None:
        kw[f"{mode}_mesh"] = mesh
    return tmodels.get_model("transformer_lm", device="cpu", **kw)


def sp_lm(rank, axes, cases):
    """The LM on a mesh of ``axes``, per case ``(kw, batch, params)``:
    - ``global``: ``Model.apply`` on the global batch on every rank (its
      train loss and the gradients of every parameter);
    - ``block``: one ``DataParallel`` step with ``P("data", "seq")`` batch
      specs (seq_lens ``P("data")``) under SGD at rate 1, so the update is
      the reduced gradient: its loss and ``p0 - p1``."""
    mesh = make_mesh(**axes)
    out = {}
    for name, (kw, batch, params) in cases.items():
        spec = _lm_spec(kw, mesh)
        ps = {k: torch.from_numpy(a.copy()).requires_grad_(True) for k, a in params.items()}
        tb = [torch.from_numpy(b) for b in batch]
        (loss, _, _), _ = spec.model.apply(Variables(ps, {}), *tb, is_train=True)
        grads = torch.autograd.grad(loss, list(ps.values()))
        res = {"global": (float(loss.detach()), {k: g.numpy() for k, g in zip(ps, grads)})}
        specs = [P("data", "seq"), P("data", "seq")] + [P("data")] * (len(batch) - 2)
        dp = DataParallel(spec.model, pt.optimizer.SGD(learning_rate=1.0), mesh=mesh,
                          device="cpu", batch_specs=specs)
        v, o = dp.init(0, *tb, variables=Variables(tensors(params), {}))
        step = dp.step(v, o, *tb)
        res["block"] = (float(step.loss), {k: params[k] - t.numpy()
                                           for k, t in step.variables.params.items()})
        res["logits_shape"] = tuple(step.outputs[2].shape)
        out[name] = res
    return out


def sp_dp_steps(rank, runs):
    """``STEPS`` DataParallel (Adam) steps per run ``(axes, kw, specs,
    zero, batch, params)``: the losses, the whole state (expert blocks and
    ZeRO-1 rows gathered), this rank's digest of it, and the routes."""
    import hashlib

    out = {}
    for name, (axes, kw, specs, zero, batch, params) in runs.items():
        mesh = make_mesh(**axes)
        spec = _lm_spec(kw, mesh)
        collective.reset_routes()
        dp = DataParallel(spec.model, spec.optimizer(), mesh=mesh, device="cpu",
                          zero_shard_optimizer=zero,
                          batch_specs=None if specs is None else [P(*s) for s in specs])
        tb = [torch.from_numpy(b) for b in batch]
        v, o = dp.init(0, *tb, variables=Variables(tensors(params), {}))
        local_shapes = {k: tuple(t.shape) for k, t in v.params.items()}
        losses = []
        for _ in range(STEPS):
            res = dp.step(v, o, *tb)
            v, o = res.variables, res.opt_state
            losses.append(float(res.loss))
        h = hashlib.sha256()
        for t in pt.core.tree.leaves(v.params):
            h.update(t.detach().numpy().tobytes())
        fv, fo = dp.full_state(v, o)
        eval_out = dp.eval_step(v, *tb)
        out[name] = dict(losses=losses, state=numpy_state(fv, fo), digest=h.hexdigest(),
                         eval_loss=float(eval_out[0]), eval_logits=eval_out[2].numpy(),
                         local_shapes=local_shapes, routes=collective.routes_taken(),
                         slot_bytes=sum(t.numel() * t.element_size()
                                        for d in o.slots.values() for t in d.values()))
    return out


def moe_gate_blocks(rank, axes, split_seq, cases):
    """Each gate case ``(router, logits [B, T, E], capacity, token_mask, wc,
    wa)`` on this rank's block of the batch (rows over ``data``, and the
    row segment over ``seq`` when ``split_seq``) inside the step context:
    its dispatch, combine and aux, and the gradient in this block's logits
    of the global ``sum(wc * combine) + wa * aux`` (each rank adds its
    block's combine term and its share, 1/size, of the global aux)."""
    from paddle_tpu_torch.parallel import context as dp_context
    from paddle_tpu_torch.parallel import moe

    mesh = make_mesh(**axes)
    axes_split = ("data", "seq") if split_seq else ("data",)
    group = dp_context.BatchGroup(mesh, axes_split, "seq" if split_seq else None)
    out = {}
    for name, (router, logits, capacity, token_mask, wc, wa) in cases.items():
        B, T, E = logits.shape
        nd = mesh.shape["data"]
        ns = mesh.shape.get("seq", 1) if split_seq else 1
        d = mesh.axis_index("data") if nd > 1 else 0
        j = mesh.axis_index("seq") if ns > 1 else 0
        rows, seg = slice(d * B // nd, (d + 1) * B // nd), slice(j * T // ns, (j + 1) * T // ns)
        x = torch.from_numpy(logits[rows, seg].copy()).requires_grad_(True)
        tm = None if token_mask is None else torch.from_numpy(token_mask[rows, seg].reshape(-1))
        with dp_context.global_batch(group):
            dispatch, combine, aux = moe._ROUTERS[router][0](
                x.reshape(-1, E), capacity, token_mask=tm, rows=x.shape[0])
            c = capacity
            weight = torch.from_numpy(wc[rows, seg].reshape(-1, E, c).copy())
            (g,) = torch.autograd.grad((weight * combine).sum() + wa * aux / group.size, [x])
        out[name] = dict(dispatch=dispatch.numpy(), combine=combine.detach().numpy(),
                         aux=float(aux.detach()), grad=g.numpy(), rows=(rows.start, rows.stop),
                         seg=(seg.start, seg.stop))
    return out


def moe_ffn_expert(rank, axes, cases):
    """``moe_ffn`` on the global tokens with its expert parameters cut to
    this rank's block (``shard_variables`` over the ``expert`` axis), per
    case ``(kw, x, token_mask, params, w)``: the output, the aux loss and
    the gradients of ``sum(w * out) + aux`` in x and the parameters (this
    rank's block of the experts')."""
    from paddle_tpu_torch.parallel import moe, shard_variables

    mesh = make_mesh(**axes)
    out = {}
    for name, (kw, x, token_mask, params, w) in cases.items():
        model = pt.build(lambda x_, tm=None: moe.moe_ffn(x_, name="moe", token_mask=tm, **kw),
                         name="moe_net")
        args = [torch.from_numpy(x)] + ([] if token_mask is None
                                        else [torch.from_numpy(token_mask)])
        model.init(0, *args, device="cpu")
        v = shard_variables(mesh, Variables(tensors(params), {}), model.param_info)
        ps = {k: t.requires_grad_(True) for k, t in v.params.items()}
        xt = args[0].requires_grad_(True)
        with mesh:
            (y, aux), _ = model.apply(Variables(ps, {}), xt, *args[1:])
            loss = (torch.from_numpy(w) * y).sum() + aux
            grads = torch.autograd.grad(loss, [xt] + list(ps.values()))
        out[name] = dict(out=y.detach().numpy(), aux=float(aux), dx=grads[0].numpy(),
                         grads={k: g.numpy() for k, g in zip(ps, grads[1:])},
                         shapes={k: tuple(t.shape) for k, t in ps.items()})
    return out


def moe_trainer(rank, roots, batches, params, jax_root):
    """``Trainer(parallel=True)`` of the MoE LM on ``expert=2`` with sharded
    checkpoints every 2 steps: two uninterrupted epochs in ``roots[0]``;
    one epoch in ``roots[1]``, then a fresh Trainer there resumes for the
    second; and the JAX package's expert-sharded checkpoint in ``jax_root``
    loaded at this rank's layout."""
    from paddle_tpu_torch.trainer import CheckpointConfig, EndStepEvent, Trainer

    mesh = make_mesh(data=1, expert=2)
    spec = tmodels.get_model("transformer_lm", device="cpu", **MOE_LM)

    def run(root, epochs):
        losses = []
        t = Trainer(lambda: spec.model, spec.optimizer, parallel=True, place="cpu",
                    parallel_kwargs=dict(mesh=mesh),
                    checkpoint_config=CheckpointConfig(root, step_interval=2, sharded=True))
        t.train(num_epochs=epochs, reader=lambda: iter(batches),
                event_handler=lambda ev: losses.append(ev.metrics)
                if isinstance(ev, EndStepEvent) else None)
        return t, losses

    whole, whole_losses = run(roots[0], 2)
    run(roots[1], 1)
    resumed, resumed_losses = run(roots[1], 2)
    fv, fo = whole._dp.full_state(whole.variables, whole.opt_state)
    out = dict(whole_losses=whole_losses, resumed_losses=resumed_losses,
               step=resumed.global_step, state=numpy_state(fv, fo),
               local_shapes={k: tuple(t.shape) for k, t in whole.variables.params.items()},
               resumed_equal=all(torch.equal(a, b) for a, b in zip(
                   pt.core.tree.leaves((whole.variables, whole.opt_state.slots)),
                   pt.core.tree.leaves((resumed.variables, resumed.opt_state.slots)))))
    dp = whole._dp
    v, o = dp.init(0, *[torch.from_numpy(b) for b in batches[0]],
                   variables=Variables(tensors(params), {}))
    (jv, jo), manifest = cks.load_sharded(jax_root, dp.state_template(v, o))
    out["jax_loaded"] = (numpy_state(*dp.full_state(jv, jo)), int(jo.step), manifest["step"])
    return out


def calls(rank, todo):
    """Several rank bodies in one spawn: ``todo`` is ``{key: (name,
    args)}``; returns ``{key: globals()[name](rank, *args)}``."""
    return {key: globals()[name](rank, *args) for key, (name, args) in todo.items()}


def sp_axes(rank, shapes):
    """On each mesh of ``shapes``: this rank's ``(axis_index, axis_size)``
    of every axis through the collectives (over the axis's process group)
    and through the mesh, and its coordinates."""
    out = []
    for axes in shapes:
        mesh = make_mesh(**axes)
        with mesh:
            got = {a: (collective.axis_index(a), collective.axis_size(a),
                       mesh.axis_index(a)) for a in mesh.axis_names}
            total = float(collective.all_reduce(torch.ones(()), mesh.axis_names[-1]))
        out.append((got, [int(c) for c in np.argwhere(mesh.devices == rank)[0]], total))
    return out


def sp_trainer(rank, batches, params):
    """``Trainer(parallel=True)`` of the ring LM on ``seq=2`` with
    ``P("data", "seq")`` batches for one epoch, against a DataParallel run
    of the same steps (losses bit-equal), and its exact evaluate against
    the gathered ``eval_step`` logits' accuracy."""
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.trainer import EndStepEvent, Trainer

    set_flags(use_flash_attention=True)
    mesh = make_mesh(data=1, seq=2)
    spec = tmodels.get_model("transformer_lm", device="cpu", ring_mesh=mesh, **SP_LM)
    specs = [P("data", "seq"), P("data", "seq")]
    losses = []
    t = Trainer(lambda: spec.model, spec.optimizer, parallel=True, place="cpu",
                parallel_kwargs=dict(mesh=mesh, batch_specs=specs))
    t.train(num_epochs=1, reader=lambda: iter(batches),
            event_handler=lambda ev: losses.append(ev.metrics)
            if isinstance(ev, EndStepEvent) else None)
    dp = DataParallel(spec.model, spec.optimizer(), mesh=mesh, device="cpu", batch_specs=specs)
    v, o = dp.init(0, *[torch.from_numpy(b) for b in batches[0]])
    dp_losses = []
    for b in batches:
        r = dp.step(v, o, *[torch.from_numpy(x) for x in b])
        v, o = r.variables, r.opt_state
        dp_losses.append(float(r.loss))

    def correct(out, ids, labels):
        return (out[2].argmax(-1).numpy() == np.asarray(labels)).mean(-1)

    metric = t.evaluate(lambda: iter(batches[:1]), correct)
    logits = dp.eval_step(t.variables, *[torch.from_numpy(x) for x in batches[0]])[2]
    want = float((logits.argmax(-1).numpy() == batches[0][1]).mean())
    return dict(losses=losses, dp_losses=dp_losses, metric=metric, want=want)


# -- tensor and pipeline parallelism ------------------------------------------
# (test_torch_tensor_parallel.py, test_torch_pipeline.py)
TP_LM = dict(seq_len=16, vocab=64, d_model=32, d_inner=64, num_heads=4, n_layers=2)
TP_NMT = dict(seq_len=8, src_vocab=32, trg_vocab=32, d_model=32, d_inner=64, num_heads=4,
              n_layers=1, max_len=16, attn_dropout=0.0, relu_dropout=0.0, residual_dropout=0.0)
# the JAX package's tests/test_lm_pipeline.py LM
PIPE_LM = dict(seq_len=16, vocab=128, d_model=32, d_inner=64, num_heads=4, n_layers=4,
               max_len=32, attn_dropout=0.0, relu_dropout=0.0, residual_dropout=0.0)


def clipped_sgd(clip, package):
    """The optimizer factory of ``clip = (class name, clip_norm, rate)``:
    SGD at ``rate`` clipping by that class of ``package.clip`` (either
    package). SGD's update scales with the clipped gradients, so a wrong
    norm shows; Adam's hardly moves when every gradient is scaled."""
    name, norm, rate = clip
    return lambda: package.optimizer.SGD(rate, grad_clip=getattr(package.clip, name)(norm))


def mp_model(kind, kw, mesh=None):
    """(model, optimizer factory) of a tensor- or pipeline-parallel case:
    ``kind`` "lm" (``kw`` may hold ``flash``, ``pipe_n_micro`` and
    ``seq_mode``, "ring" or "ulysses" over ``mesh``; else a mesh with a
    ``pipe`` axis becomes its ``pipe_mesh``), "nmt" or "mlp";
    ``kw["grad_clip"]``: a clipped SGD instead (:func:`clipped_sgd`)."""
    from paddle_tpu_torch.core.config import set_flags

    kw = dict(kw)
    set_flags(use_flash_attention=kw.pop("flash", False))
    clip = kw.pop("grad_clip", None)
    mode = kw.pop("seq_mode", None)
    if kind == "mlp":
        return port_model("mlp")
    if kind == "nmt":
        spec = tmodels.get_model("transformer", device="cpu", **kw)
    else:
        if mode is not None:
            kw[f"{mode}_mesh"] = mesh
        elif mesh is not None and mesh.shape.get("pipe", 1) > 1:
            kw["pipe_mesh"] = mesh
        spec = tmodels.get_model("transformer_lm", device="cpu", **kw)
    return spec.model, spec.optimizer if clip is None else clipped_sgd(clip, pt)


def mp_apply(rank, axes, cases):
    """``Model.apply`` (training mode) on the global batch on every rank of
    a mesh of ``axes``, per case ``(kind, kw, batch, params)``: parameters
    split over ``model`` cut to this rank's blocks (``shard_variables``).
    Returns the loss, the logits, this rank's gradient of every parameter
    (its block; a pipeline's are whole on every stage) and the shapes it
    held."""
    from paddle_tpu_torch.parallel import shard_variables

    mesh = make_mesh(**axes)
    out = {}
    for name, (kind, kw, batch, params) in cases.items():
        model, _ = mp_model(kind, kw, mesh)
        tb = [torch.from_numpy(b) for b in batch]
        model.init(0, *tb, device="cpu")
        v = shard_variables(mesh, Variables(tensors(params), {}), model.param_info)
        ps = {k: t.clone().requires_grad_(True) for k, t in v.params.items()}
        with mesh:
            (loss, _, logits), _ = model.apply(Variables(ps, {}), *tb, is_train=True)
            grads = torch.autograd.grad(loss, list(ps.values()))
        out[name] = dict(loss=float(loss.detach()), logits=logits.detach().numpy(),
                         grads={k: g.numpy() for k, g in zip(ps, grads)},
                         shapes={k: tuple(t.shape) for k, t in v.params.items()})
    return out


def mp_init_blocks(rank, kind, kw, batch):
    """``Model.init`` inside ``with mesh:`` on ``model=2``: each parameter
    annotated over ``model`` as this rank's block; returns whether every
    block equals that slice of the one-device init (bit for bit) and the
    names of the parameters held as blocks."""
    from paddle_tpu_torch.parallel import param_shardings
    from paddle_tpu_torch.parallel.sharding import cut_block

    mesh = make_mesh(data=1, model=2)
    model, _ = mp_model(kind, kw)
    tb = [torch.from_numpy(b) for b in batch]
    whole = model.init(0, *tb, device="cpu").params
    with mesh:
        blocks = model.init(0, *tb, device="cpu").params
    specs = param_shardings(mesh, model.param_info, whole)
    split = sorted(k for k in whole if blocks[k].shape != whole[k].shape)
    equal = all(torch.equal(blocks[k], cut_block(whole[k], [
        (d, a) for d, a in enumerate(specs[k].spec) if a == "model"], mesh)) for k in whole)
    return dict(equal=equal, split=split)


def mp_dp_steps(rank, runs):
    """``STEPS`` DataParallel steps per run ``(axes, kind, kw, zero, batch,
    params)``: the losses, the whole state (``model`` blocks and ZeRO-1 rows
    gathered), this rank's digest of its parameters, the shapes it held,
    the gathered eval logits' shape and the slot bytes it kept."""
    import hashlib

    out = {}
    for name, (axes, kind, kw, zero, batch, params) in runs.items():
        mesh = make_mesh(**axes)
        model, opt = mp_model(kind, kw, mesh)
        dp = DataParallel(model, opt(), mesh=mesh, device="cpu", zero_shard_optimizer=zero)
        tb = [torch.from_numpy(b) for b in batch]
        v, o = dp.init(0, *tb, variables=Variables(tensors(params), {}))
        local_shapes = {k: tuple(t.shape) for k, t in v.params.items()}
        losses = []
        for _ in range(STEPS):
            res = dp.step(v, o, *tb)
            v, o = res.variables, res.opt_state
            losses.append(float(res.loss))
        h = hashlib.sha256()
        for t in pt.core.tree.leaves(v.params):
            h.update(t.detach().numpy().tobytes())
        fv, fo = dp.full_state(v, o)
        pv, po = dp.place_state(fv, fo)  # whole -> this rank's blocks again
        placed = all(torch.equal(a, b) for a, b in zip(
            pt.core.tree.leaves((v, o.slots)), pt.core.tree.leaves((pv, po.slots))))
        ev = dp.eval_step(v, *tb)
        out[name] = dict(losses=losses, state=numpy_state(fv, fo), digest=h.hexdigest(),
                         placed_round_trip=placed,
                         local_shapes=local_shapes,
                         eval_shapes=[tuple(getattr(t, "shape", ())) for t in
                                      pt.core.tree.leaves(ev)],
                         slot_bytes=sum(t.numel() * t.element_size()
                                        for d in o.slots.values() for t in d.values()))
    return out


def mp_dropout(rank, runs):
    """One step with dropout on a ``model`` axis per run ``(axes, kind,
    kw, batch, params)``, held against the port's own one-device step drawn
    from the same generator (each mask drawn at the whole shape and cut to
    the rank's block): the losses and the largest parameter difference."""
    out = {}
    for name, (axes, kind, kw, batch, params) in runs.items():
        mesh = make_mesh(**axes)
        model, opt = mp_model(kind, kw, mesh)
        dp = DataParallel(model, opt(), mesh=mesh, device="cpu")
        tb = [torch.from_numpy(b) for b in batch]
        v, o = dp.init(0, *tb, variables=Variables(tensors(params), {}))
        res = dp.step(v, o, *tb, rng=torch.Generator().manual_seed(7))
        fv, _ = dp.full_state(res.variables, res.opt_state)
        # DataParallel's stream for token block 0: a seed drawn from rng
        seed = int(torch.randint(2 ** 62, (), generator=torch.Generator().manual_seed(7)))
        ref_opt = opt()
        v0 = Variables(tensors(params), {})
        ref = ref_opt.minimize(model)(v0, ref_opt.create_state(v0.params), *tb,
                                      rng=torch.Generator().manual_seed(seed))
        nodrop = ref_opt.minimize(model)(v0, ref_opt.create_state(v0.params), *tb,
                                         rng=torch.Generator().manual_seed(seed + 1))
        out[name] = dict(loss=float(res.loss), ref_loss=float(ref.loss),
                         other_mask_loss=float(nodrop.loss),
                         max_diff=max(float((fv.params[k] - ref.variables.params[k]).abs().max())
                                      for k in fv.params))
    return out


def mp_trainer(rank, roots, batches, params, jax_root, axes):
    """``Trainer(parallel=True)`` of the LM on a mesh of ``axes`` with
    sharded checkpoints every 2 steps: two uninterrupted epochs in
    ``roots[0]``; one epoch in ``roots[1]``, then a fresh Trainer there
    resumes for the second; and the JAX package's ``data=2 x model=2``
    checkpoint in ``jax_root`` loaded at this rank's layout."""
    from paddle_tpu_torch.trainer import CheckpointConfig, EndStepEvent, Trainer

    mesh = make_mesh(**axes)
    model, opt = mp_model("lm", TP_LM)

    def run(root, epochs):
        losses = []
        t = Trainer(lambda: model, opt, parallel=True, place="cpu",
                    parallel_kwargs=dict(mesh=mesh),
                    checkpoint_config=CheckpointConfig(root, step_interval=2, sharded=True))
        t.train(num_epochs=epochs, reader=lambda: iter(batches),
                event_handler=lambda ev: losses.append(ev.metrics)
                if isinstance(ev, EndStepEvent) else None)
        return t, losses

    whole, whole_losses = run(roots[0], 2)
    run(roots[1], 1)
    resumed, resumed_losses = run(roots[1], 2)
    fv, fo = whole._dp.full_state(whole.variables, whole.opt_state)
    out = dict(whole_losses=whole_losses, resumed_losses=resumed_losses,
               step=resumed.global_step, state=numpy_state(fv, fo),
               local_shapes={k: tuple(t.shape) for k, t in whole.variables.params.items()},
               resumed_equal=all(torch.equal(a, b) for a, b in zip(
                   pt.core.tree.leaves((whole.variables, whole.opt_state.slots)),
                   pt.core.tree.leaves((resumed.variables, resumed.opt_state.slots)))))
    dp = whole._dp
    v, o = dp.init(0, *[torch.from_numpy(b) for b in batches[0]],
                   variables=Variables(tensors(params), {}))
    (jv, jo), manifest = cks.load_sharded(jax_root, dp.state_template(v, o))
    out["jax_loaded"] = (numpy_state(*dp.full_state(jv, jo)), int(jo.step), manifest["step"])
    out["jax_loaded_shapes"] = {k: tuple(t.shape) for k, t in jv.params.items()}
    return out


def mp_pipeline(rank, axes, cases):
    """``pipeline_apply`` on a mesh of ``axes`` per case ``(stage kind,
    stage params, x, n_micro, remat, w)``: the outputs, and this rank's
    gradients of ``sum(w * out)`` in the stacked parameters and the input
    (whole on every stage)."""
    from paddle_tpu_torch.parallel import pipeline_apply, split_microbatches, stack_stage_params

    mesh = make_mesh(**axes)
    out = {}
    for name, (kind, stage_params, x, n_micro, remat, w) in cases.items():
        def stage_fn(p, h):
            y = h @ p["w"] + p["b"] if "b" in p else h @ p["w"]
            return torch.tanh(y)

        stacked = stack_stage_params([tensors(p) for p in stage_params])
        stacked = {k: t.requires_grad_(True) for k, t in stacked.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        mbs = split_microbatches(xt, n_micro)
        y = pipeline_apply(stage_fn, stacked, mbs, mesh, remat=remat)
        grads = torch.autograd.grad((torch.from_numpy(w) * y).sum(), [xt] + list(stacked.values()))
        out[name] = dict(out=y.detach().numpy(), dx=grads[0].numpy(),
                         grads={k: g.numpy() for k, g in zip(stacked, grads[1:])},
                         routes=collective.routes_taken())
    return out


# -- the axes composed (test_torch_composed_parallel.py) ------------------------
def cx_trainer(rank, root, axes, kw, specs, zero, batches, jax_root):
    """``Trainer(parallel=True)`` of the LM (``kw`` as :func:`mp_model`'s)
    on a mesh of ``axes`` (``specs``: the batch specs, or None; ``zero``:
    ZeRO-1) for one epoch of ``batches``, a sharded checkpoint at its end
    in ``root``: its losses, step and whole state; and, given
    ``jax_root``, the JAX package's checkpoint there loaded at this rank's
    layout (gathered whole)."""
    from paddle_tpu_torch.trainer import CheckpointConfig, EndStepEvent, Trainer

    mesh = make_mesh(**axes)
    model, opt = mp_model("lm", kw, mesh)
    kwargs = dict(mesh=mesh, zero_shard_optimizer=zero)
    if specs is not None:
        kwargs["batch_specs"] = [P(*s) for s in specs]
    losses = []
    t = Trainer(lambda: model, opt, parallel=True, place="cpu", parallel_kwargs=kwargs,
                checkpoint_config=CheckpointConfig(root, step_interval=len(batches),
                                                   sharded=True))
    t.train(num_epochs=1, reader=lambda: iter(batches),
            event_handler=lambda ev: losses.append(ev.metrics)
            if isinstance(ev, EndStepEvent) else None)
    dp = t._dp
    out = dict(losses=losses, step=t.global_step,
               state=numpy_state(*dp.full_state(t.variables, t.opt_state)),
               local_shapes={k: tuple(v.shape) for k, v in t.variables.params.items()})
    if jax_root is not None:
        (jv, jo), manifest = cks.load_sharded(jax_root, dp.state_template(t.variables,
                                                                           t.opt_state))
        out["jax_loaded"] = (numpy_state(*dp.full_state(jv, jo)), int(jo.step),
                             manifest["step"])
    return out


# -- any mesh and spec (test_torch_any_mesh.py) ---------------------------------
def store_rows(model, axis="data"):
    """Replace the annotation of every parameter of two dims or more of a
    built model (``param_info`` recorded by an init) by dim 0 split over
    ``axis``: a stored block (FSDP-like). Works on either package's model."""
    for info in model.param_info.values():
        if len(info.shape) >= 2:
            info.sharding = (axis,) + (None,) * (len(info.shape) - 1)


def kept_tokens():
    """The MoE routers (``parallel.moe._ROUTERS``) of this rank process
    wrapped once: each call appends ``(routes kept over the step's tokens,
    aux loss)`` to the returned list (inside a step the count is summed over
    its token blocks)."""
    from paddle_tpu_torch.parallel import context as dp_context
    from paddle_tpu_torch.parallel import moe

    calls = getattr(kept_tokens, "calls", None)
    if calls is None:
        calls = kept_tokens.calls = []

        def wrap(fn):
            def gate(logits, capacity, token_mask=None, rows=None):
                dispatch, combine, aux = fn(logits, capacity, token_mask=token_mask, rows=rows)
                calls.append((int(dp_context.global_sum(dispatch.sum())), float(aux.detach())))
                return dispatch, combine, aux

            return gate

        for name, (fn, routes) in list(moe._ROUTERS.items()):
            moe._ROUTERS[name] = (wrap(fn), routes)
    return calls


def am_model(run, mesh):
    """(model, optimizer factory) of an any-mesh run: ``run["model"]`` "mlp"
    or "lm" (``run["kw"]`` as :func:`_lm_spec`'s)."""
    if run["model"] == "mlp":
        return port_model("mlp")
    spec = _lm_spec(run["kw"], mesh)
    return spec.model, spec.optimizer


def am_steps(rank, runs):
    """``STEPS`` DataParallel steps per run (a dict: ``axes``, ``model``,
    ``kw``, ``specs`` (entries of P per arg, or None), ``zero``, ``stored``
    (:func:`store_rows`), ``batch``, ``params``; optionally ``save``: a root
    for a sharded checkpoint after the steps, ``load``: the JAX package's
    checkpoint root to load at this rank's layout, ``pad``: rows of a
    ragged batch for ``pad_batch``). Returns the losses, the whole state,
    this rank's digest of its parameters, the shapes, parameter and slot
    bytes it held, the routers' first-step kept tokens and aux losses, the
    step's token axes and the batch arithmetic."""
    import hashlib

    out = {}
    for name, run in runs.items():
        mesh = make_mesh(**run["axes"])
        model, opt = am_model(run, mesh)
        tb = [torch.from_numpy(b) for b in run["batch"]]
        if not model.param_info:
            model.init(0, *tb, device="cpu")
        if run.get("stored"):
            store_rows(model)
        specs = run.get("specs")
        dp = DataParallel(model, opt(), mesh=mesh, device="cpu",
                          zero_shard_optimizer=run.get("zero", False),
                          batch_specs=None if specs is None else [P(*s) for s in specs])
        v, o = dp.init(0, *tb, variables=Variables(tensors(run["params"]), {}))
        res = dict(local_shapes={k: tuple(t.shape) for k, t in v.params.items()},
                   param_bytes=sum(t.numel() * t.element_size() for t in v.params.values()),
                   slot_bytes=sum(t.numel() * t.element_size()
                                  for d in o.slots.values() for t in d.values()),
                   token_axes=dp._token_axes, leading_multiple=dp.leading_multiple(*tb))
        if run.get("load"):
            (lv, lo), manifest = cks.load_sharded(run["load"], dp.state_template(v, o))
            res["loaded"] = (numpy_state(*dp.full_state(lv, lo)), int(lo.step), manifest["step"])
        calls = kept_tokens() if run["model"] == "lm" and run["kw"].get("moe_experts") else []
        losses, routers = [], None
        for _ in range(STEPS):
            calls.clear()
            step = dp.step(v, o, *tb)
            v, o = step.variables, step.opt_state
            losses.append(float(step.loss))
            routers = list(calls) if routers is None else routers
        h = hashlib.sha256()
        for t in pt.core.tree.leaves(v.params):
            h.update(t.detach().numpy().tobytes())
        if run.get("save"):
            cks.save_sharded(run["save"], (v, o), step=STEPS, template=dp.state_template(v, o))
        if run.get("pad"):
            padded, mask = dp.pad_batch(*(b[:run["pad"]] for b in run["batch"]))
            res["pad"] = ([np.asarray(b) for b in padded], mask,
                          [np.asarray(dp.rank_rows(b)) for b in padded])
        res.update(losses=losses, state=numpy_state(*dp.full_state(v, o)), digest=h.hexdigest(),
                   routers=routers)
        out[name] = res
    return out


def am_trainer(rank, roots, axes, kw, specs, batches):
    """``Trainer(parallel=True)`` of the LM (``kw`` as :func:`_lm_spec`'s)
    on a mesh of ``axes`` with batch specs ``specs``, sharded async
    checkpoints every 2 steps: two uninterrupted epochs in ``roots[0]``; one
    epoch in ``roots[1]``, then a fresh Trainer there resumes for the
    second. Returns both runs' losses, the step and whether the resumed
    state equals the uninterrupted one bit for bit."""
    from paddle_tpu_torch.trainer import CheckpointConfig, EndStepEvent, Trainer

    mesh = make_mesh(**axes)
    spec = _lm_spec(kw, mesh)

    def run(root, epochs):
        losses = []
        t = Trainer(lambda: spec.model, spec.optimizer, parallel=True, place="cpu",
                    parallel_kwargs=dict(mesh=mesh, batch_specs=[P(*s) for s in specs]),
                    checkpoint_config=CheckpointConfig(root, step_interval=2, sharded=True,
                                                       async_save=True))
        t.train(num_epochs=epochs, reader=lambda: iter(batches),
                event_handler=lambda ev: losses.append(ev.metrics)
                if isinstance(ev, EndStepEvent) else None)
        return t, losses

    whole, whole_losses = run(roots[0], 2)
    run(roots[1], 1)
    resumed, resumed_losses = run(roots[1], 2)
    return dict(whole_losses=whole_losses, resumed_losses=resumed_losses,
                step=resumed.global_step,
                local_shapes={k: tuple(t.shape) for k, t in whole.variables.params.items()},
                resumed_equal=all(torch.equal(a, b) for a, b in zip(
                    pt.core.tree.leaves((whole.variables, whole.opt_state.slots)),
                    pt.core.tree.leaves((resumed.variables, resumed.opt_state.slots)))))

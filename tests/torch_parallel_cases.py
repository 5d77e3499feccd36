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

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import checkpoint_sharded as cks
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.framework import Variables
from paddle_tpu_torch.parallel import DataParallel, collective, make_mesh

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

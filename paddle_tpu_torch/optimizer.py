"""Optimizers — port of ``paddle_tpu/optimizer.py``.

Reference: ``python/paddle/fluid/optimizer.py:38-1208`` — Optimizer base
(minimize = append_backward + regularize/clip + per-param optimize ops) and
SGD/Momentum/Adagrad/Adam/Adamax/DecayedAdagrad/Adadelta/RMSProp/Ftrl/
ModelAverage (``paddle/fluid/operators/*_op.cc``).

Each optimizer is a per-parameter update rule in f32. ``minimize`` wires
``torch.autograd`` (:func:`paddle_tpu_torch.backward.value_and_grad`) +
regularization + clipping + the update into one train-step function with
the JAX package's signature. As in the JAX package the step is functional:
it returns new parameter and slot tensors and leaves the caller's
``variables`` and ``opt_state`` unchanged. ``OptState.step`` is a Python
int, so learning-rate schedules run on the host without a device sync.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch import lr_scheduler as lrs
from paddle_tpu_torch import regularizer as reg_mod
from paddle_tpu_torch.backward import value_and_grad
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import Model, ParamInfo, Variables


class OptState(NamedTuple):
    step: int  # global step: updates applied so far
    slots: Dict[str, Dict[str, torch.Tensor]]  # slot name → per-param dict


class StepOutput(NamedTuple):
    variables: Variables
    opt_state: OptState
    loss: torch.Tensor
    outputs: Any
    # set (0-dim bool tensor on the loss's device) when flags().check_nan_inf
    # is on: whether the loss and every gradient are finite — the analogue
    # of the reference's per-op FLAGS_check_nan_inf (operator.cc:725-737)
    finite: Any = None


def _stack(outs):
    """Microbatch outputs stacked on a new leading [accum_steps] dim (what
    the JAX package's ``lax.scan`` returns)."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([o[i] for o in outs]) for i in range(len(first)))
    return torch.tensor(outs)


def all_finite(grads, loss: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whether every gradient entry (and ``loss``, if given) is finite, as a
    0-dim bool tensor, in a constant number of launches over all the
    gradients. Multiplying by 0 maps each finite entry to 0 and each inf or
    NaN to NaN (exact, unlike a norm: a finite 1e30 squares to inf); one
    ``_foreach`` norm of those products is then finite exactly when all of
    them are 0. The reference's predicate (``jnp.all(jnp.isfinite(g))`` per
    leaf)."""
    grads = [g for g in grads if g.numel()]
    total = torch.stack(torch._foreach_norm(torch._foreach_mul(grads, 0.0))).sum() if grads else None
    if loss is not None:
        total = loss * 0.0 if total is None else total + loss * 0.0
    if total is None:
        return torch.tensor(True)
    return torch.isfinite(total)


def _pmean(loss, grads, new_state, state, outputs, axis_name: str):
    """The pmap form's reductions: the mean over ``axis_name`` of every
    gradient, of the loss and of each state entry the step changed."""
    from paddle_tpu_torch.parallel import collective

    with torch.no_grad():
        grads = {k: collective.all_reduce(g, axis_name, "mean") for k, g in grads.items()}
        loss = collective.all_reduce(loss, axis_name, "mean")
        new_state = {k: v if v is state.get(k) else collective.all_reduce(v, axis_name, "mean")
                     for k, v in new_state.items()}
    return loss, grads, new_state, outputs


class Optimizer:
    """Base optimizer. Subclasses define slot init + per-leaf update.
    ``elementwise``: the update of each entry reads only that entry of the
    parameter, gradient and slots, so it may run on any slice of them
    (``DataParallel(zero_shard_optimizer=True)`` updates each rank's rows)."""

    elementwise = True

    def __init__(self, learning_rate=0.001, regularization=None, grad_clip=None, name: Optional[str] = None):
        self.scheduler = lrs.resolve(learning_rate)
        self.regularization = regularization
        self.grad_clip = grad_clip
        self.name = name or type(self).__name__

    # -- subclass interface -------------------------------------------------
    def _slot_names(self) -> Tuple[str, ...]:
        return ()

    def _init_slot(self, slot: str, param: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(param, dtype=torch.float32)

    def _update(self, param, grad, lr, slots: Dict[str, torch.Tensor], step: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    # -- state --------------------------------------------------------------
    def create_state(self, params: Dict[str, torch.Tensor]) -> OptState:
        slots = {
            s: {k: self._init_slot(s, p) for k, p in params.items()}
            for s in self._slot_names()
        }
        return OptState(step=0, slots=slots)

    # -- functional application --------------------------------------------
    def apply_gradients(
        self,
        params: Dict[str, torch.Tensor],
        grads: Dict[str, torch.Tensor],
        opt_state: OptState,
        param_info: Optional[Dict[str, ParamInfo]] = None,
    ) -> Tuple[Dict[str, torch.Tensor], OptState]:
        """One update in f32: regularization, clipping, then each trainable
        parameter's rule at the scheduled rate times its ``learning_rate``
        multiplier. Returns new dicts; the inputs are not modified."""
        grads = self.prepare_gradients(params, grads, param_info)
        return self.update(params, grads, opt_state, param_info)

    def prepare_gradients(self, params, grads, param_info=None,
                          sq_norms=None) -> Dict[str, torch.Tensor]:
        """Regularization, then clipping: the part of an update that reads
        whole gradients (a global norm). ``sq_norms``: the whole gradients'
        squared norms where ``grads`` hold blocks (``clip.py``)."""
        grads = reg_mod.apply_regularization(params, grads, self.regularization, param_info)
        if self.grad_clip is not None:
            grads = (self.grad_clip(grads) if sq_norms is None
                     else self.grad_clip(grads, sq_norms=sq_norms))
        return grads

    def update(
        self,
        params: Dict[str, torch.Tensor],
        grads: Dict[str, torch.Tensor],
        opt_state: OptState,
        param_info: Optional[Dict[str, ParamInfo]] = None,
    ) -> Tuple[Dict[str, torch.Tensor], OptState]:
        """Each trainable parameter's rule on prepared gradients."""
        lr = self.scheduler(opt_state.step)
        new_params = dict(params)
        new_slots = {s: dict(d) for s, d in opt_state.slots.items()}
        # name-aware updates (Lamb's decay/trust exclusions) declare a
        # `name` parameter on _update; plain optimizers keep the short form
        accepts_name = "name" in inspect.signature(self._update).parameters
        with torch.no_grad():
            for name, p in params.items():
                info = param_info.get(name) if param_info else None
                if info is not None and not info.trainable:
                    continue
                g = grads[name].float()
                p_lr = lr * (info.learning_rate if info is not None else 1.0)
                slot_view = {s: new_slots[s][name] for s in self._slot_names()}
                kw = {"name": name} if accepts_name else {}
                new_p, slot_out = self._update(p.float(), g, p_lr, slot_view, opt_state.step, **kw)
                new_params[name] = new_p.to(p.dtype)
                for s, v in slot_out.items():
                    new_slots[s][name] = v
        return new_params, OptState(step=opt_state.step + 1, slots=new_slots)

    def minimize(
        self,
        model: Model,
        loss_index: int = 0,
        axis_name: Optional[str] = None,
        accum_steps: int = 1,
    ) -> Callable:
        """Build the full train-step function (the analogue of fluid
        ``optimizer.minimize(avg_cost)`` + Executor.run of the resulting
        program):

            step_fn(variables, opt_state, *batch, rng=None)
                -> StepOutput(variables, opt_state, loss, outputs, finite)

        ``accum_steps > 1`` splits each batch arg's leading dim into that
        many microbatches and accumulates f32 gradients over them before
        the single optimizer update: activation memory then scales with the
        microbatch. Equivalent to the full-batch step for mean losses;
        ``outputs`` carries a leading [accum_steps] dim. ``rng`` (a
        ``torch.Generator``) is the training-mode random stream.

        When ``axis_name`` is given, the gradients, the loss and the
        changed state (BN statistics) are mean-reduced over that axis of
        the current mesh (:mod:`paddle_tpu_torch.parallel.collective`) — the
        pmap form of data parallelism, replacing the reference's
        AllReduceOpHandle + ScaleLossGradOpHandle pair
        (``details/all_reduce_op_handle.cc:48``,
        ``scale_loss_grad_op_handle.cc:63``). Each rank's batch reductions
        stay its own, as in the JAX package; ``DataParallel`` is the form
        whose step equals the single-device step on the global batch.
        """
        reduce = None
        if axis_name is not None:
            def reduce(loss, grads, new_state, state, outputs):
                return _pmean(loss, grads, new_state, state, outputs, axis_name)
        return self.train_step(model, loss_index, accum_steps, reduce=reduce)

    def train_step(self, model: Model, loss_index: int = 0, accum_steps: int = 1,
                   reduce: Optional[Callable] = None, apply: Optional[Callable] = None) -> Callable:
        """:meth:`minimize`'s step with two hooks for data parallelism:
        ``reduce(loss, grads, new_state, state, outputs) -> (loss, grads,
        new_state, outputs)`` runs between the backward and the update, and
        ``apply(params, grads, opt_state, param_info) -> (params,
        opt_state)`` replaces :meth:`apply_gradients`."""
        enforce(accum_steps >= 1, f"accum_steps must be >= 1, got {accum_steps}")
        apply = apply or self.apply_gradients

        def grad_of(params, state, batch, rng):
            def loss_fn(p):
                out, new_state = model.apply(Variables(p, state), *batch, rng=rng, is_train=True)
                loss = out[loss_index] if isinstance(out, (tuple, list)) else out
                return torch.mean(loss.float()), (new_state, out)

            return value_and_grad(loss_fn, has_aux=True)(params)

        def finish(params, state, opt_state, loss, new_state, grads, outputs):
            if reduce is not None:
                loss, grads, new_state, outputs = reduce(loss, grads, new_state, state, outputs)
            new_params, new_opt = apply(params, grads, opt_state, model.param_info)
            finite = None
            from paddle_tpu_torch.core import config as _cfg

            if _cfg.flags().check_nan_inf:
                finite = all_finite(grads.values(), loss)
            return StepOutput(Variables(new_params, new_state), new_opt, loss, outputs, finite)

        def step_fn(variables: Variables, opt_state: OptState, *batch, rng=None):
            params, state = variables.params, variables.state
            (loss, (new_state, outputs)), grads = grad_of(params, state, batch, rng)
            return finish(params, state, opt_state, loss, new_state, grads, outputs)

        if accum_steps == 1:
            return step_fn

        def accum_step_fn(variables: Variables, opt_state: OptState, *batch, rng=None):
            params, state = variables.params, variables.state
            n = accum_steps
            micro = []
            for b in batch:
                b = torch.as_tensor(b)
                enforce(
                    b.shape[0] % n == 0,
                    f"batch dim {b.shape[0]} not divisible by accum_steps {n}",
                )
                micro.append(b.reshape((n, b.shape[0] // n) + tuple(b.shape[1:])))
            gsum, lsum, outs = None, 0.0, []
            for i in range(n):
                (loss, (state, out)), grads = grad_of(params, state, tuple(m[i] for m in micro), rng)
                if gsum is None:
                    gsum = {k: g.float() for k, g in grads.items()}
                else:
                    gsum = {k: gsum[k] + g.float() for k, g in grads.items()}
                lsum = lsum + loss
                outs.append(out)
            grads = {k: (g / n).to(params[k].dtype) for k, g in gsum.items()}
            return finish(params, variables.state, opt_state, lsum / n, state, grads, _stack(outs))

        return accum_step_fn


class SGD(Optimizer):
    """Plain SGD (reference ``sgd_op.cc``)."""

    def _update(self, p, g, lr, slots, step):
        return p - lr * g, {}


class Momentum(Optimizer):
    """Heavy-ball / Nesterov momentum (reference ``momentum_op.cc``)."""

    def __init__(self, learning_rate, momentum: float = 0.9, use_nesterov: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _slot_names(self):
        return ("velocity",)

    def _update(self, p, g, lr, slots, step):
        v = self.momentum * slots["velocity"] + g
        if self.use_nesterov:
            new_p = p - lr * (g + self.momentum * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}


class LARS(Optimizer):
    """Layer-wise Adaptive Rate Scaling with momentum: per-parameter
    effective lr = lr * ||p|| / (||g|| + wd*||p||)."""

    elementwise = False  # the rate reads the whole parameter's norms

    def __init__(self, learning_rate, momentum: float = 0.9, lars_weight_decay: float = 0.0005, epsilon: float = 1e-9, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.lars_weight_decay = lars_weight_decay
        self.epsilon = epsilon

    def _slot_names(self):
        return ("velocity",)

    def _update(self, p, g, lr, slots, step):
        p_norm = torch.sqrt(torch.sum(torch.square(p)))
        g_norm = torch.sqrt(torch.sum(torch.square(g)))
        local_lr = lr * p_norm / (g_norm + self.lars_weight_decay * p_norm + self.epsilon)
        v = self.momentum * slots["velocity"] + local_lr * (g + self.lars_weight_decay * p)
        return p - v, {"velocity": v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon: float = 1e-6, initial_accumulator_value: float = 0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon
        self.init_acc = initial_accumulator_value

    def _slot_names(self):
        return ("moment",)

    def _init_slot(self, slot, param):
        return torch.full_like(param, self.init_acc, dtype=torch.float32)

    def _update(self, p, g, lr, slots, step):
        m = slots["moment"] + torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self.epsilon), {"moment": m}


class Adam(Optimizer):
    """Adam with the reference's bias-correction-in-lr formulation
    (``adam_op.cc``: lr * sqrt(1-b2^t)/(1-b1^t))."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8, lazy_mode: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _slot_names(self):
        return ("moment1", "moment2")

    def _update(self, p, g, lr, slots, step):
        t = float(step + 1)
        m1 = self.beta1 * slots["moment1"] + (1 - self.beta1) * g
        m2 = self.beta2 * slots["moment2"] + (1 - self.beta2) * torch.square(g)
        lr_t = lr * (1 - self.beta2 ** t) ** 0.5 / (1 - self.beta1 ** t)
        new_p = p - lr_t * m1 / (torch.sqrt(m2) + self.epsilon)
        return new_p, {"moment1": m1, "moment2": m2}


def _name_excluded(name: str, tokens: Tuple[str, ...]) -> bool:
    """Decay-exclusion matching: tokens without '/' match the LEAF name
    exactly; tokens containing '/' match anywhere in the full scoped name
    (whole-scope exclusions)."""
    leaf = name.rsplit("/", 1)[-1]
    for tok in tokens:
        if "/" in tok:
            if tok in name:
                return True
        elif tok == leaf:
            return True
    return False


class AdamW(Adam):
    """Adam with DECOUPLED weight decay (Loshchilov & Hutter), applied to the
    parameter directly and scaled by the schedule. ``exclude_from_decay``
    tokens without '/' match the leaf parameter name, tokens with '/' match
    anywhere in the scoped name."""

    def __init__(
        self, learning_rate=0.001, beta1: float = 0.9, beta2: float = 0.999,
        epsilon: float = 1e-8, weight_decay: float = 0.01,
        exclude_from_decay: Tuple[str, ...] = ("b", "bias", "scale", "norm"),
        **kw,
    ):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self.weight_decay = weight_decay
        self.exclude_from_decay = tuple(exclude_from_decay)

    def update(self, params, grads, opt_state, param_info=None):
        lr = self.scheduler(opt_state.step)  # pre-increment step, as base does
        new_params, new_state = super().update(params, grads, opt_state, param_info)
        if not self.weight_decay:
            return new_params, new_state
        # decoupled decay as a post-pass against the PRE-update params:
        # p_{t+1} = p_t - lr*adam(g) - lr*wd*p_t
        with torch.no_grad():
            for name, p in params.items():
                info = param_info.get(name) if param_info else None
                if info is not None and not info.trainable:
                    continue
                if _name_excluded(name, self.exclude_from_decay):
                    continue
                p_lr = lr * (info.learning_rate if info is not None else 1.0)
                new_params[name] = (
                    new_params[name].float() - p_lr * self.weight_decay * p.float()
                ).to(p.dtype)
        return new_params, new_state


class Lamb(Optimizer):
    """LAMB (You et al.): the Adam update direction rescaled per layer by
    ||p|| / ||update||; biases and norm parameters get no decay and
    trust 1."""

    elementwise = False  # the trust ratio reads the whole parameter's norms

    def __init__(
        self, learning_rate=0.001, beta1: float = 0.9, beta2: float = 0.999,
        epsilon: float = 1e-6, weight_decay: float = 0.01,
        exclude_from_decay: Tuple[str, ...] = ("b", "bias", "scale", "norm"),
        **kw,
    ):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay
        self.exclude_from_decay = tuple(exclude_from_decay)

    def _slot_names(self):
        return ("moment1", "moment2")

    def _update(self, p, g, lr, slots, step, name=""):
        t = float(step + 1)
        m1 = self.beta1 * slots["moment1"] + (1 - self.beta1) * g
        m2 = self.beta2 * slots["moment2"] + (1 - self.beta2) * torch.square(g)
        m1_hat = m1 / (1 - self.beta1 ** t)
        m2_hat = m2 / (1 - self.beta2 ** t)
        excluded = _name_excluded(name, self.exclude_from_decay)
        wd = 0.0 if excluded else self.weight_decay
        update = m1_hat / (torch.sqrt(m2_hat) + self.epsilon) + wd * p
        if excluded:
            return p - lr * update, {"moment1": m1, "moment2": m2}
        p_norm = torch.linalg.norm(p)
        u_norm = torch.linalg.norm(update)
        trust = torch.where(
            (p_norm > 0) & (u_norm > 0), p_norm / torch.clamp(u_norm, min=1e-12), 1.0
        )
        return p - lr * trust * update, {"moment1": m1, "moment2": m2}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _slot_names(self):
        return ("moment", "inf_norm")

    def _update(self, p, g, lr, slots, step):
        t = float(step + 1)
        m = self.beta1 * slots["moment"] + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * slots["inf_norm"], torch.abs(g))
        lr_t = lr / (1 - self.beta1 ** t)
        new_p = p - lr_t * m / (u + self.epsilon)
        return new_p, {"moment": m, "inf_norm": u}


class DecayedAdagrad(Optimizer):
    def __init__(self, learning_rate, decay: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def _slot_names(self):
        return ("moment",)

    def _update(self, p, g, lr, slots, step):
        m = self.decay * slots["moment"] + (1 - self.decay) * torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self.epsilon), {"moment": m}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=1.0, epsilon: float = 1e-6, rho: float = 0.95, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon, self.rho = epsilon, rho

    def _slot_names(self):
        return ("avg_squared_grad", "avg_squared_update")

    def _update(self, p, g, lr, slots, step):
        sg = self.rho * slots["avg_squared_grad"] + (1 - self.rho) * torch.square(g)
        update = g * torch.sqrt(slots["avg_squared_update"] + self.epsilon) / torch.sqrt(sg + self.epsilon)
        su = self.rho * slots["avg_squared_update"] + (1 - self.rho) * torch.square(update)
        return p - lr * update, {"avg_squared_grad": sg, "avg_squared_update": su}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho: float = 0.95, epsilon: float = 1e-6, momentum: float = 0.0, centered: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon, self.momentum, self.centered = rho, epsilon, momentum, centered

    def _slot_names(self):
        return ("mean_square", "moment", "mean_grad") if self.centered else ("mean_square", "moment")

    def _update(self, p, g, lr, slots, step):
        ms = self.rho * slots["mean_square"] + (1 - self.rho) * torch.square(g)
        out = {"mean_square": ms}
        if self.centered:
            mg = self.rho * slots["mean_grad"] + (1 - self.rho) * g
            denom = torch.sqrt(ms - torch.square(mg) + self.epsilon)
            out["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self.epsilon)
        mom = self.momentum * slots["moment"] + lr * g / denom
        out["moment"] = mom
        return p - mom, out


class Ftrl(Optimizer):
    """FTRL-proximal (reference ``ftrl_op.cc``)."""

    def __init__(self, learning_rate, l1: float = 0.0, l2: float = 0.0, lr_power: float = -0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def _slot_names(self):
        return ("squared", "linear")

    def _update(self, p, g, lr, slots, step):
        sq_new = slots["squared"] + torch.square(g)
        sigma = (torch.pow(sq_new, -self.lr_power)
                 - torch.pow(torch.clamp(slots["squared"], min=1e-12), -self.lr_power)) / lr
        lin = slots["linear"] + g - sigma * p
        quad = torch.pow(sq_new, -self.lr_power) / lr + 2 * self.l2
        pre = torch.clamp(lin, -self.l1, self.l1) - lin
        new_p = torch.where(torch.abs(lin) > self.l1, pre / quad, torch.zeros_like(p))
        return new_p, {"squared": sq_new, "linear": lin}


class ModelAverage:
    """Polyak-style parameter averaging over a sliding window (reference
    ``optimizer.py`` ModelAverage). Functional: feed every new params dict
    to ``update``; ``average()`` yields eval params."""

    def __init__(self, average_window_rate: float = 0.15, min_average_window: int = 10000, max_average_window: int = 10000):
        self.rate = average_window_rate
        self.min_window = min_average_window
        self.max_window = max_average_window

    def create_state(self, params):
        return {
            "sum": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "count": 0,
            "updates": 0,
        }

    def _window(self, num_updates: int) -> int:
        # the window grows with training length at average_window_rate,
        # clamped to [min, max]
        w = float(int(num_updates * self.rate))
        return int(min(max(w, self.min_window), self.max_window))

    def update(self, state, params):
        updates = state["updates"] + 1
        window = self._window(updates)
        decay = 1.0 - 1.0 / window if state["count"] >= window else 1.0
        with torch.no_grad():
            new_sum = {k: s * decay + params[k].float() for k, s in state["sum"].items()}
        return {"sum": new_sum, "count": min(state["count"] + 1, window), "updates": updates}

    def average(self, state, like_params):
        c = float(max(state["count"], 1))
        return {k: (s / c).to(like_params[k].dtype) for k, s in state["sum"].items()}


# fluid-style aliases
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
DecayedAdagradOptimizer = DecayedAdagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl

"""Automatic mixed precision: dtype casting + loss scaling — port of
``paddle_tpu/transpiler/amp.py``.

Reference: ``paddle/contrib/float16/float16_transpiler.py`` (rewrite an
inference program to fp16), extended in the JAX package to mixed-precision
training: parameters and optimizer state f32 (master weights), the forward
on parameters cast to bf16 (or fp16), and dynamic loss scaling for the
fp16 recipe.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from paddle_tpu_torch.backward import value_and_grad
from paddle_tpu_torch.core import dtypes as dt
from paddle_tpu_torch.core import tree as tree_mod
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.framework import Model, Variables
from paddle_tpu_torch.optimizer import Optimizer, OptState, all_finite

__all__ = ["cast_params", "DynamicLossScale", "AmpStepOutput", "amp_minimize"]


def cast_params(tree, dtype="bfloat16"):
    """Cast the floating leaves of a parameter/state tree to ``dtype``
    (float16_transpiler parity: its pass rewrote persistable variables'
    dtypes and inserted cast ops); other leaves are left as they are."""
    target = dt.convert(dtype)

    def cast(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf.to(target)
        return leaf

    return tree_mod.map_leaves(cast, tree)


class DynamicLossScale(NamedTuple):
    """Dynamic loss-scaling state (the standard fp16 recipe; Fluid's fp16
    was inference-only): the current multiplier and the count of
    consecutive finite steps, as 0-dim tensors on the card."""

    scale: torch.Tensor
    good_steps: torch.Tensor

    @staticmethod
    def create(initial: float = 2.0 ** 15, device="cuda") -> "DynamicLossScale":
        """``device``: default CUDA; raises if CUDA is absent unless
        ``device="cpu"``."""
        dev = resolve_device(device)
        return DynamicLossScale(scale=torch.tensor(initial, dtype=torch.float32, device=dev),
                                good_steps=torch.zeros((), dtype=torch.int32, device=dev))

    def update(self, grads_finite, growth_interval: int = 2000, factor: float = 2.0):
        """Grow the scale by ``factor`` after ``growth_interval`` finite
        steps in a row, halve it (``/ factor``) on a non-finite step; the
        scale stays in [1, 2^24]."""
        grown = torch.where(self.good_steps + 1 >= growth_interval, self.scale * factor, self.scale)
        new_scale = torch.where(grads_finite, grown, self.scale / factor).clamp(1.0, 2.0 ** 24)
        new_good = torch.where(grads_finite & (self.good_steps + 1 < growth_interval),
                               self.good_steps + 1, torch.zeros_like(self.good_steps))
        return DynamicLossScale(scale=new_scale, good_steps=new_good)


class AmpStepOutput(NamedTuple):
    variables: Variables
    opt_state: OptState
    loss: torch.Tensor
    loss_scale: Optional[DynamicLossScale]
    grads_finite: torch.Tensor


def amp_minimize(
    optimizer: Optimizer,
    model: Model,
    loss_index: int = 0,
    compute_dtype="bfloat16",
    use_loss_scaling: bool = False,
) -> Callable:
    """Mixed-precision train step builder.

    Returns ``step_fn(variables, opt_state, loss_scale, *batch, rng=None)
    -> AmpStepOutput``. The forward runs on the parameters cast to
    ``compute_dtype``; gradients and the update stay f32 on the f32 master
    weights. With ``use_loss_scaling`` (the fp16 recipe) the loss is
    multiplied by the dynamic scale and the gradients divided by it, and a
    step whose gradients are not all finite is skipped — ``torch.where``
    keeps the old value of every parameter and optimizer slot — while the
    scale backs off. The optimizer's step counter is a host int, so that
    case reads ``grads_finite`` once per step.
    """

    def step_fn(variables: Variables, opt_state: OptState, loss_scale: Optional[DynamicLossScale],
                *batch, rng=None) -> AmpStepOutput:
        params, state = variables.params, variables.state
        scale_val: Any = loss_scale.scale if use_loss_scaling else 1.0

        def loss_fn(p):
            out, new_state = model.apply(Variables(cast_params(p, compute_dtype), state), *batch,
                                         rng=rng, is_train=True)
            loss = out[loss_index] if isinstance(out, (tuple, list)) else out
            loss = torch.mean(loss.float())
            return loss * scale_val, (new_state, loss)

        (_, (new_state, loss)), grads = value_and_grad(loss_fn, has_aux=True)(params)
        grads = {k: g.float() / scale_val for k, g in grads.items()}
        finite = all_finite(grads.values())
        new_params, new_opt = optimizer.apply_gradients(params, grads, opt_state, model.param_info)
        if use_loss_scaling:
            # skip the update when gradients overflowed
            new_params = {k: torch.where(finite, n, params[k]) for k, n in new_params.items()}
            new_slots = {s: {k: torch.where(finite, n, opt_state.slots[s][k]) for k, n in d.items()}
                         for s, d in new_opt.slots.items()}
            new_opt = OptState(step=new_opt.step if bool(finite) else opt_state.step,
                               slots=new_slots)
            loss_scale = loss_scale.update(finite)
        return AmpStepOutput(Variables(new_params, new_state), new_opt, loss, loss_scale, finite)

    return step_fn

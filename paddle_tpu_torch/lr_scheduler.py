"""Learning-rate schedules — port of ``paddle_tpu/lr_scheduler.py``.

Reference: ``python/paddle/fluid/layers/learning_rate_scheduler.py``
(exponential/natural_exp/inverse_time/polynomial/piecewise/noam decays).
Each schedule is a function of the integer global step (the optimizer's
``OptState.step``, a Python int in the port) that returns the learning
rate as a Python float: the update's arithmetic stays on the device, the
schedule on the host, and no step needs a device sync to read its rate.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from paddle_tpu_torch.core.enforce import enforce


class LRScheduler:
    def __call__(self, step: int) -> float:
        raise NotImplementedError


class Constant(LRScheduler):
    def __init__(self, learning_rate: float):
        self.lr = float(learning_rate)

    def __call__(self, step):
        return self.lr


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int, decay_rate: float, staircase: bool = False):
        self.lr, self.decay_steps, self.decay_rate, self.staircase = learning_rate, decay_steps, decay_rate, staircase

    def __call__(self, step):
        exp = step / self.decay_steps
        if self.staircase:
            exp = math.floor(exp)
        return self.lr * self.decay_rate ** exp


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int, decay_rate: float, staircase: bool = False):
        self.lr, self.decay_steps, self.decay_rate, self.staircase = learning_rate, decay_steps, decay_rate, staircase

    def __call__(self, step):
        exp = step / self.decay_steps
        if self.staircase:
            exp = math.floor(exp)
        return self.lr * math.exp(-self.decay_rate * exp)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int, decay_rate: float, staircase: bool = False):
        self.lr, self.decay_steps, self.decay_rate, self.staircase = learning_rate, decay_steps, decay_rate, staircase

    def __call__(self, step):
        frac = step / self.decay_steps
        if self.staircase:
            frac = math.floor(frac)
        return self.lr / (1.0 + self.decay_rate * frac)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int, end_learning_rate: float = 1e-4, power: float = 1.0, cycle: bool = False):
        self.lr, self.decay_steps, self.end_lr, self.power, self.cycle = learning_rate, decay_steps, end_learning_rate, power, cycle

    def __call__(self, step):
        s = float(step)
        if self.cycle:
            decay_steps = self.decay_steps * math.ceil(max(s / self.decay_steps, 1.0))
        else:
            decay_steps = float(self.decay_steps)
            s = min(s, decay_steps)
        return (self.lr - self.end_lr) * (1 - s / decay_steps) ** self.power + self.end_lr


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: Sequence[int], values: Sequence[float]):
        enforce(
            len(values) == len(boundaries) + 1,
            "PiecewiseDecay needs len(values) == len(boundaries) + 1, got "
            f"{len(values)} values for {len(boundaries)} boundaries",
        )
        self.boundaries = [int(b) for b in boundaries]
        self.values = [float(v) for v in values]

    def __call__(self, step):
        lr = self.values[0]
        for b, v in zip(self.boundaries, self.values[1:]):
            if step >= b:
                lr = v
        return lr


class NoamDecay(LRScheduler):
    """Transformer schedule (reference noam_decay): d^-0.5 * min(s^-0.5, s*w^-1.5)."""

    def __init__(self, d_model: int, warmup_steps: int, learning_rate: float = 1.0):
        self.d_model, self.warmup, self.lr = d_model, warmup_steps, learning_rate

    def __call__(self, step):
        s = max(float(step), 1.0)
        return self.lr * (self.d_model ** -0.5) * min(s ** -0.5, s * (self.warmup ** -1.5))


class CosineDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int, alpha: float = 0.0):
        self.lr, self.decay_steps, self.alpha = learning_rate, decay_steps, alpha

    def __call__(self, step):
        frac = min(max(step / self.decay_steps, 0.0), 1.0)
        cosine = 0.5 * (1 + math.cos(math.pi * frac))
        return self.lr * ((1 - self.alpha) * cosine + self.alpha)


class LinearWarmup(LRScheduler):
    def __init__(self, inner: LRScheduler, warmup_steps: int, start_lr: float = 0.0):
        self.inner, self.warmup, self.start_lr = inner, warmup_steps, start_lr

    def __call__(self, step):
        target = self.inner(step)
        if step >= self.warmup:
            return target
        return self.start_lr + (target - self.start_lr) * min(step / self.warmup, 1.0)


# fluid-style lowercase aliases
exponential_decay = ExponentialDecay
natural_exp_decay = NaturalExpDecay
inverse_time_decay = InverseTimeDecay
polynomial_decay = PolynomialDecay
piecewise_decay = PiecewiseDecay
noam_decay = NoamDecay
cosine_decay = CosineDecay


def resolve(lr) -> LRScheduler:
    if isinstance(lr, LRScheduler):
        return lr
    return Constant(float(lr))


def append_LARS(base_lr, param, grad, weight_decay: float = 0.0005, lars_coeff: float = 0.001, epsilon: float = 1e-9):
    """Layer-wise adaptive rate scaling (reference
    ``layers/learning_rate_scheduler.py`` append_LARS): the base LR for one
    parameter scaled by lars_coeff * ||w|| / (||g|| + wd * ||w||), as a
    0-dim f32 tensor on the parameter's device."""
    wn = torch.sqrt(torch.sum(torch.square(param.float())))
    gn = torch.sqrt(torch.sum(torch.square(grad.float())))
    local = lars_coeff * wn / (gn + weight_decay * wn + epsilon)
    return base_lr * local

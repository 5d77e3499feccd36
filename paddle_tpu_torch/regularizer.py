"""Weight-decay regularizers — port of ``paddle_tpu/regularizer.py``.

Reference: ``python/paddle/fluid/regularizer.py`` — L1/L2 decay appended
onto each parameter's gradient. Per-parameter regularizers recorded in
``ParamAttr`` are honored by ``Optimizer.apply_gradients``, which calls
:func:`apply_regularization` on every update.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops import math as om


class Regularizer:
    def grad_term(self, param: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def loss_term(self, param: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class L2Decay(Regularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def grad_term(self, param):
        return self.coeff * param

    def loss_term(self, param):
        return 0.5 * self.coeff * torch.sum(torch.square(param))


class L1Decay(Regularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def grad_term(self, param):
        return self.coeff * torch.sign(param)

    def loss_term(self, param):
        return self.coeff * torch.sum(om.abs(param))  # gradient coeff at 0, as jnp.abs


L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay


def apply_regularization(params: dict, grads: dict, default_reg=None, param_info=None) -> dict:
    """Add per-param (or default) regularizer terms to gradients; mirrors
    the reference append_regularization_ops (regularizer.py)."""
    out = dict(grads)
    for name, g in grads.items():
        reg = None
        if param_info and name in param_info and param_info[name].regularizer is not None:
            reg = param_info[name].regularizer
        elif default_reg is not None:
            reg = default_reg
        if reg is not None:
            out[name] = g + reg.grad_term(params[name]).to(g.dtype)
    return out

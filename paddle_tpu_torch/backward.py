"""Autodiff entry points — port of ``paddle_tpu/backward.py``, the
``append_backward`` equivalent.

Reference: ``python/paddle/fluid/backward.py:469`` (append_backward) and
``backward.py:685`` (calc_gradient). The backward pass is
``torch.autograd`` over the eagerly-run program. These wrappers keep the
JAX package's API shape (loss in, gradients by parameter name out): a
differentiated argument is a tensor or a dict, list or tuple of tensors,
and its gradient comes back in the same structure, with zeros for entries
the value does not depend on. Values and auxiliary outputs come back
detached from the graph.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from paddle_tpu_torch.framework import Model, Variables

__all__ = ["append_backward", "calc_gradient", "value_and_grad", "stop_gradient"]


def _flatten(tree):
    """``(leaves, rebuild)`` of a tensor or a flat dict/list/tuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda xs: type(tree)(xs)
    raise TypeError(
        f"can differentiate a tensor or a dict/list/tuple of tensors, not {type(tree).__name__}")


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(v) for v in tree)
    return tree


def value_and_grad(fn: Callable, argnums: Union[int, Sequence[int]] = 0, has_aux: bool = False):
    """``jax.value_and_grad`` on ``torch.autograd``: the returned function
    gives ``(value, grads)``, or ``((value, aux), grads)`` with
    ``has_aux``; ``fn`` returns a scalar tensor (or ``(scalar, aux)``).
    ``grads`` has the structure of ``args[argnums]`` (a tuple of such
    when ``argnums`` is a sequence)."""
    nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    def wrapped(*args, **kwargs):
        args = list(args)
        flat = []
        for i in nums:
            leaves, rebuild = _flatten(args[i])
            leaves = [t.detach().requires_grad_() for t in leaves]
            args[i] = rebuild(leaves)
            flat.append((leaves, rebuild))
        every = [t for leaves, _ in flat for t in leaves]
        with torch.enable_grad():
            out = fn(*args, **kwargs)
            value, aux = out if has_aux else (out, None)
            grads = torch.autograd.grad(value, every, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(every, grads)]
        per_arg, at = [], 0
        for leaves, rebuild in flat:
            per_arg.append(rebuild(grads[at:at + len(leaves)]))
            at += len(leaves)
        g = per_arg[0] if isinstance(argnums, int) else tuple(per_arg)
        value = value.detach()
        return ((value, _detach(aux)), g) if has_aux else (value, g)

    return wrapped


def append_backward(
    model: Model,
    *args,
    state: Optional[dict] = None,
    rng=None,
    no_grad_set: Optional[set] = None,
    **kwargs,
):
    """Return a function params → (loss, (grads, new_state, aux)) for the
    model whose first (or only) output is the scalar loss.

    ``no_grad_set`` (param names) mirrors the reference's no_grad pruning:
    those parameters get zero gradients and are not differentiated.
    """

    def loss_fn(params, state_in):
        out, new_state = model.apply(
            Variables(params, state_in or {}), *args, rng=rng, is_train=True, **kwargs
        )
        loss = out[0] if isinstance(out, (tuple, list)) else out
        return torch.mean(loss), (new_state, out)

    def run(params, state_in=None):
        diff = {k: v for k, v in params.items() if not no_grad_set or k not in no_grad_set}
        frozen = {k: v for k, v in params.items() if no_grad_set and k in no_grad_set}

        def fn(p):
            return loss_fn({**p, **frozen}, state_in if state_in is not None else state)

        (loss, (new_state, out)), grads = value_and_grad(fn, has_aux=True)(diff)
        grads.update({k: torch.zeros_like(v) for k, v in frozen.items()})
        return loss, (grads, new_state, out)

    return run


def calc_gradient(fn: Callable, argnums: Union[int, Sequence[int]] = 0):
    """Gradient of an arbitrary function (reference calc_gradient)."""

    def grad(*args, **kwargs):
        return value_and_grad(fn, argnums)(*args, **kwargs)[1]

    return grad


def stop_gradient(x):
    """Reference ``@GRAD`` blocking / stop_gradient attr."""
    return x.detach()

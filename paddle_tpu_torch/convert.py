"""Carry parameters and optimizer state between the JAX package and the
port.

Both packages name parameters identically (``framework.name_scope``), so a
flat ``{name: array}`` dict moves across unchanged: this is how the tests
run the two packages on identical weights, and how a checkpoint written by
one loads into the other. Mutable state (BatchNorm's moving statistics) is
a second such dict: :func:`variables_from_jax` carries ``Variables(params,
state)``. Optimizer state moves the same way: its step and its slot dicts
(``{slot: {param name: array}}``). A whole training state
``(Variables, OptState)`` moves with :func:`train_state_from_jax`, and
:func:`train_state_leaves` lists it in checkpoint leaf order
(``jax.tree_util.tree_leaves`` order) as numpy arrays. A state split over
ranks crosses whole: ``np.asarray`` of a JAX array sharded over ``model``
or ``expert`` is the whole array, which ``DataParallel.place_state`` cuts
to each rank's blocks, and ``DataParallel.full_state`` gathers the port's
blocks back.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from paddle_tpu_torch.core.config import resolve_device

__all__ = ["params_from_jax", "params_to_numpy", "variables_from_jax", "opt_state_from_jax",
           "opt_state_to_numpy", "train_state_from_jax", "train_state_leaves"]


def _to_tensor(value, device: torch.device) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16).to(device)
    # a copy: arrays exported by JAX are read-only, and tensors own their memory
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)


def params_from_jax(params: Mapping[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """``{name: array}`` (numpy arrays, or anything ``np.asarray`` takes,
    such as JAX arrays) → ``{name: tensor}`` on ``device`` (default CUDA;
    raises if CUDA is absent unless ``device="cpu"``). Dtypes are kept."""
    dev = resolve_device(device)
    return {name: _to_tensor(value, dev) for name, value in params.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``{name: tensor}`` → ``{name: numpy array}`` on the host. bf16
    tensors come back as float32 (numpy has no bfloat16; the values are
    exact)."""
    out = {}
    for name, t in params.items():
        t = t.detach().cpu()
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def variables_from_jax(variables: Any, device="cuda"):
    """The JAX package's ``Variables(params, state)`` (or a ``(params,
    state)`` pair of dicts) → the port's ``Variables`` on ``device``
    (default CUDA; raises if CUDA is absent unless ``device="cpu"``)."""
    from paddle_tpu_torch.framework import Variables

    params, state = variables
    return Variables(params_from_jax(params, device), params_from_jax(state, device))


def opt_state_from_jax(state: Any, device="cuda"):
    """An optimizer state with ``step`` and ``slots`` (the JAX package's
    ``OptState``, or the dict :func:`opt_state_to_numpy` returns) → the
    port's :class:`~paddle_tpu_torch.optimizer.OptState` on ``device``
    (default CUDA; raises if CUDA is absent unless ``device="cpu"``)."""
    from paddle_tpu_torch.optimizer import OptState

    step, slots = (state["step"], state["slots"]) if isinstance(state, Mapping) else (
        state.step, state.slots)
    return OptState(step=int(np.asarray(step)),
                    slots={s: params_from_jax(d, device) for s, d in slots.items()})


def opt_state_to_numpy(state) -> Dict[str, Any]:
    """An ``OptState`` → ``{"step": int, "slots": {slot: {name: numpy
    array}}}`` on the host."""
    return {"step": int(np.asarray(state.step)),
            "slots": {s: params_to_numpy(d) for s, d in state.slots.items()}}


def train_state_from_jax(tree: Any, device="cuda"):
    """A training state ``(variables, opt_state)`` of the JAX package (its
    ``Variables`` and ``OptState``, or the same pairs of numpy dicts) →
    ``(Variables, OptState)`` of the port on ``device`` (default CUDA;
    raises if CUDA is absent unless ``device="cpu"``): parameters, mutable
    state, the optimizer's step and every slot."""
    variables, opt_state = tree
    return variables_from_jax(variables, device), opt_state_from_jax(opt_state, device)


def train_state_leaves(tree: Any) -> List[np.ndarray]:
    """The leaves of a training state of either package as numpy arrays, in
    checkpoint order: parameters by name, state by name, the step (0-d
    int32), then the slots by slot name and parameter name."""
    from paddle_tpu_torch.core import tree as tree_mod

    def host(leaf):
        if isinstance(leaf, torch.Tensor):
            return params_to_numpy({"_": leaf})["_"]
        if isinstance(leaf, int):
            return np.asarray(leaf, np.int32)
        return np.asarray(leaf)

    (params, state), opt_state = tree
    step, slots = (opt_state["step"], opt_state["slots"]) if isinstance(opt_state, Mapping) else (
        opt_state.step, opt_state.slots)
    return [host(l) for l in tree_mod.leaves(((params, state), (step, slots)))]

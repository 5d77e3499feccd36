"""Model persistence: parameters and inference-model export — port of
``paddle_tpu/io.py``.

Reference: ``python/paddle/fluid/io.py:89-506`` (save/load_vars/params/
persistables via save/load ops), ``io.py:544`` save_inference_model,
``io.py:670`` load_inference_model. Parameters serialize as the JAX
package's flat name→array archive (``params.npz`` + ``state.npz`` + a JSON
``manifest.json`` with dtype/shape/framework version), so either package
loads the other's. The inference program, a StableHLO ``jax.export`` in
the JAX package, is a ``torch.export`` program here (``program.pt2``,
``torch.export.save``) beside that archive: the model's eval-mode forward
at the example arguments' shapes, with the parameters as inputs. The
flash-attention forward is in it as the operator
``paddle_tpu_torch::flash_fwd``, so the loaded program runs the
hand-written kernel on the card. The C++-predictor artifact
(``native=True``, ``native/``) is not ported yet (``ROADMAP.md`` §A
item 8).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.convert import params_from_jax, params_to_numpy
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.framework import Model, Variables
from paddle_tpu_torch.version import __version__

__all__ = ["save_params", "load_params", "save_persistables", "load_persistables",
           "save_vars", "load_vars", "save_inference_model", "load_inference_model"]

_MANIFEST = "manifest.json"
_PARAMS_FILE = "params.npz"
_STATE_FILE = "state.npz"
_PROGRAM_FILE = "program.pt2"


def _save_dict(d: Dict[str, torch.Tensor], path: str) -> None:
    for k, v in d.items():
        if v.dtype == torch.bfloat16:
            raise EnforceError(f"{k!r} is bfloat16, which npz cannot store")
    np.savez(path, **params_to_numpy(d))


def _load_dict(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _manifest_entry(d: Dict[str, torch.Tensor]) -> dict:
    return {k: {"shape": list(v.shape), "dtype": str(v.dtype).replace("torch.", "")}
            for k, v in d.items()}


def save_params(dirname: str, variables: Variables, filename_prefix: str = "") -> None:
    """save_persistables parity: trainable params + mutable state."""
    os.makedirs(dirname, exist_ok=True)
    _save_dict(variables.params, os.path.join(dirname, filename_prefix + _PARAMS_FILE))
    _save_dict(variables.state, os.path.join(dirname, filename_prefix + _STATE_FILE))
    manifest = {
        "framework_version": __version__,
        "params": _manifest_entry(variables.params),
        "state": _manifest_entry(variables.state),
    }
    with open(os.path.join(dirname, filename_prefix + _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def load_vars(dirname: str, predicate=None, filename_prefix: str = "", device="cuda") -> Variables:
    """Load, keeping only names satisfying ``predicate`` (reference
    ``io.load_vars``), onto ``device`` (default CUDA; ``"cpu"`` to stay on
    the host). Filters the host-side arrays before any device transfer."""
    pred = predicate or (lambda name: True)
    params = _load_dict(os.path.join(dirname, filename_prefix + _PARAMS_FILE))
    state_path = os.path.join(dirname, filename_prefix + _STATE_FILE)
    state = _load_dict(state_path) if os.path.exists(state_path) else {}
    return Variables(
        params=params_from_jax({k: v for k, v in params.items() if pred(k)}, device),
        state=params_from_jax({k: v for k, v in state.items() if pred(k)}, device),
    )


def load_params(dirname: str, filename_prefix: str = "", device="cuda") -> Variables:
    return load_vars(dirname, None, filename_prefix, device)


# full reference io surface (reference io.py:28 __all__): persistables =
# params + mutable state here, and save_vars/load_vars take an explicit
# name predicate instead of the reference's Variable-object filters
save_persistables = save_params
load_persistables = load_params


def save_vars(dirname: str, variables: Variables, predicate=None,
              filename_prefix: str = "") -> None:
    """Save the subset of variables whose NAME satisfies ``predicate``
    (reference ``io.save_vars``; default: everything)."""
    pred = predicate or (lambda name: True)
    sub = Variables(
        params={k: v for k, v in variables.params.items() if pred(k)},
        state={k: v for k, v in variables.state.items() if pred(k)},
    )
    save_params(dirname, sub, filename_prefix)


class FunctionModule(torch.nn.Module):
    """A function as the ``torch.nn.Module`` that ``torch.export`` traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


def save_inference_model(
    dirname: str,
    model: Model,
    variables: Variables,
    example_args: Sequence[Any],
    rng=None,
    native: bool = False,
) -> None:
    """Export an inference program (reference save_inference_model): the
    model traced by ``torch.export`` in eval mode at ``example_args``'
    shapes, on the device that holds ``variables``, with the parameters as
    inputs, saved as ``program.pt2`` beside :func:`save_params`' archive.
    A program ``torch.export`` cannot capture raises the exporter's own
    error. ``native=True`` (the C++-predictor artifact) raises
    ``NotImplementedError``."""
    if native:
        raise NotImplementedError(
            "save_inference_model(native=True): the C++ predictor's export (native/) is not "
            "ported to paddle_tpu_torch yet (ROADMAP.md §A item 8)")
    from paddle_tpu_torch.executor import to_device

    dev = next(iter(variables.params.values())).device
    args = tuple(to_device(a, dev) for a in example_args)
    def infer_fn(params, state, *a):
        out, _ = model.apply(Variables(params, state), *a, rng=rng, is_train=False)
        return out

    with torch.no_grad():
        program = torch.export.export(
            FunctionModule(infer_fn), (variables.params, variables.state, *args))
    # the parameters are the program's inputs and are saved beside it: the
    # program keeps no second copy of them as its example inputs
    program.example_inputs = None
    os.makedirs(dirname, exist_ok=True)
    torch.export.save(program, os.path.join(dirname, _PROGRAM_FILE))
    save_params(dirname, variables)
    ptlog.info("inference model saved to %s", dirname)


def load_inference_model(dirname: str, device="cuda") -> Tuple[Callable, Variables]:
    """Returns ``(run, variables)``: ``run(*args)`` calls the loaded program
    on the saved parameters (reference load_inference_model), which load
    onto ``device`` (default CUDA; the program runs where it was exported)."""
    from paddle_tpu_torch.executor import to_device
    from paddle_tpu_torch.ops.cuda import flash_attention  # noqa: F401  (the operator)

    dev = resolve_device(device)
    program = torch.export.load(os.path.join(dirname, _PROGRAM_FILE)).module()
    variables = load_params(dirname, device=dev)

    def run(*args):
        with torch.no_grad():
            return program(variables.params, variables.state,
                           *(to_device(a, dev) for a in args))

    return run, variables

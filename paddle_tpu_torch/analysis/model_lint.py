"""Model linter: trace a :class:`framework.Model` on the ``meta`` device
and report structural problems before they cost card time — port of
``paddle_tpu/analysis/model_lint.py``.

The reference framework caught these classes of bug one at a time, at run
time (``PADDLE_ENFORCE`` in InferShape, duplicate-variable checks on a
``BlockDesc``, regularizer plumbing in the optimizer). Here the model is
traced once with every tensor on PyTorch's ``meta`` device — shapes and
dtypes only, no data, no kernel launched, no device memory (the JAX
package's ``jax.eval_shape``) — and every finding comes back as a
structured :class:`Diagnostic`:

* ``param-collision`` — two ``create_parameter`` calls resolve to the same
  full name (explicit ``ParamAttr.name`` reuse inside one scope);
* ``init-error`` — ``init`` itself fails;
* ``init-apply-mismatch`` — ``apply`` requests a parameter ``init`` never
  created, or with a different shape;
* ``unused-param`` — a parameter exists in the variable set but no apply
  path reads it (checkpoint/config drift; sees through
  ``gather_layer_params`` via the frame's read ledger);
* ``sharding-rank`` — a ``ParamAttr.sharding`` spec whose rank disagrees
  with the parameter's shape (placement would reject it);
* ``float64-leak`` — a parameter, state entry or output in float64: on
  the card that is twice the memory and bandwidth of f32 and runs far
  below the f32/bf16 tensor-core rates, a silent slow path;
* ``stale-state`` — a state entry created in init but never updated by a
  training-mode apply (a moving statistic that never moves);
* ``cross-scope-state`` — an ``update_state`` that only resolved through
  the bare-name fallback (see ``framework.update_state``);
* ``regularizer-non-trainable`` — weight decay attached to a frozen
  parameter: it would silently do nothing.

Where it differs from the JAX package: ``example_inputs`` may be tensors
(on any device), numpy arrays or ``(shape, dtype)`` specs, and given
variables are replaced by ``meta`` tensors of the same shape and dtype
(``torch.empty_like``: nothing is copied off the card). ``rng`` seeds the
``torch.Generator`` of init and of a training-mode apply's draws. An op
that has to read a value on the host (``.item()``, ``.tolist()``, a copy
to numpy) cannot run on ``meta``: the trace stops there, and the finding
(``init-error`` or ``init-apply-mismatch``) names the op and where the
model called it.

Used directly (``lint_model``) and as the serving warm-up hook
(``serving.engine.ServingEngine`` lints the model it is about to serve
and logs the findings).
"""

from __future__ import annotations

import os
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.analysis.diagnostics import WARNING, Diagnostic
from paddle_tpu_torch.core.enforce import EnforceError

__all__ = ["lint_model"]

_META = torch.device("meta")
# lowercase texts of the errors an op raises on meta tensors when it needs
# their values (.item(), .tolist(), numpy, a data-dependent shape)
_HOST_READ_MARKERS = ("meta tensor", "meta device", "'meta' backend", "_local_scalar_dense",
                      "data-dependent", "cannot copy out of meta")
_TORCH_DIR = os.path.dirname(torch.__file__)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    from paddle_tpu_torch.core import dtypes as dtypes_mod

    try:
        return dtypes_mod.convert(dtype)
    except (KeyError, TypeError):  # a numpy dtype, or a name numpy knows
        return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _meta(x) -> torch.Tensor:
    """A ``meta`` tensor of ``x``'s shape and dtype: ``x`` a tensor, an
    array (or anything with ``shape`` and ``dtype``) or a ``(shape,
    dtype)`` spec."""
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device=_META)
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], (tuple, list, torch.Size)):
        shape, dtype = x
    elif hasattr(x, "shape") and hasattr(x, "dtype"):
        shape, dtype = x.shape, x.dtype
    else:
        arr = np.asarray(x)
        shape, dtype = arr.shape, arr.dtype
    return torch.empty(tuple(int(s) for s in shape), dtype=_torch_dtype(dtype), device=_META)


def _split_variables(variables) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    if hasattr(variables, "params"):
        return dict(variables.params), dict(getattr(variables, "state", {}) or {})
    if isinstance(variables, tuple) and len(variables) == 2:
        return dict(variables[0]), dict(variables[1] or {})
    return dict(variables), {}


def _is_f64(dtype) -> bool:
    return dtype == torch.float64 or str(dtype) in ("float64", "f64", "torch.float64")


def _host_read(e: BaseException) -> Optional[str]:
    """When ``e`` is an op's refusal to read a ``meta`` tensor's value:
    the op's error and the model code that called it; else None."""
    if isinstance(e, EnforceError) or not isinstance(e, (RuntimeError, NotImplementedError,
                                                          TypeError, ValueError)):
        return None
    text = str(e).strip().splitlines()[0] if str(e).strip() else type(e).__name__
    if not any(m in str(e).lower() for m in _HOST_READ_MARKERS):
        return None
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if not f.filename.startswith(_TORCH_DIR) and f.filename != __file__]
    at = f" at {frames[-1].filename}:{frames[-1].lineno} in {frames[-1].name}" if frames else ""
    return f"{type(e).__name__}: {text}{at} — the op reads a value on the host, which a " \
           "meta trace has not got"


def lint_model(
    model,
    example_inputs: Sequence,
    variables=None,
    rng: int = 0,
    train: bool = True,
) -> List[Diagnostic]:
    """Trace ``model`` on the ``meta`` device over ``example_inputs`` and
    return diagnostics; nothing is computed and no device memory is
    touched. When ``variables`` is omitted, ``model.init`` is traced too
    (enabling the init-vs-apply checks); otherwise the given variable set
    is linted against a single apply trace."""
    from paddle_tpu_torch.core import tree as tree_mod
    from paddle_tpu_torch.framework import Model, Variables, _recording_reads, build

    if not isinstance(model, Model):
        model = build(model)
    diags: List[Diagnostic] = []
    inputs = tuple(_meta(x) for x in example_inputs)

    init_info = None
    if variables is None:
        try:
            with torch.no_grad():
                variables = model.init(torch.Generator().manual_seed(int(rng)), *inputs,
                                       device=_META)
        except Exception as e:
            found = str(e) if isinstance(e, EnforceError) else _host_read(e)
            if found is None:
                raise
            code = "param-collision" if "duplicate parameter" in found else "init-error"
            diags.append(Diagnostic(code, found, where=f"{model.name}.init"))
            return diags
        init_info = dict(model.param_info)
    else:
        params, state = _split_variables(variables)
        variables = Variables({k: _meta(v) for k, v in params.items()},
                              {k: _meta(v) for k, v in state.items()})
    params, state = _split_variables(variables)

    try:
        with torch.no_grad(), _recording_reads() as ledger:
            out = model.apply(variables, *inputs, rng=torch.Generator().manual_seed(int(rng)),
                              is_train=train)
    except Exception as e:
        found = str(e) if isinstance(e, EnforceError) else _host_read(e)
        if found is None:
            raise
        diags.append(Diagnostic("init-apply-mismatch", found, where=f"{model.name}.apply"))
        return diags

    # this trace's own ledger: another thread may apply the same model meanwhile
    reads = set(ledger["param_reads"])
    updated = set(ledger["state_updates"])
    cross_scope = set(ledger["cross_scope_updates"])

    # -- structural: params present but never read by this apply trace
    for name in sorted(set(params) - reads):
        diags.append(Diagnostic(
            "unused-param",
            f"parameter {name!r} exists in the variable set but no apply path reads it "
            "(checkpoint/config drift, or a branch this trace did not take)",
            severity=WARNING, where=name))

    # -- per-param metadata (init's records win: they cover every parameter;
    # an apply-only trace still covers what it read)
    info = dict(ledger["param_info"])
    info.update(init_info or {})
    for name, pi in sorted(info.items()):
        if pi.sharding is not None and len(pi.sharding) != len(pi.shape):
            diags.append(Diagnostic(
                "sharding-rank",
                f"parameter {name!r} has sharding spec {pi.sharding} of rank "
                f"{len(pi.sharding)} but shape {pi.shape} of rank {len(pi.shape)} — "
                "placement (parallel.sharding) would reject it",
                where=name))
        if _is_f64(pi.dtype):
            diags.append(Diagnostic(
                "float64-leak",
                f"parameter {name!r} is declared float64: on the card that is twice the "
                "memory and bandwidth of f32 and runs far below the f32/bf16 tensor-core "
                "rates; the port's code is f32/bf16",
                where=name))
        if pi.regularizer is not None and not pi.trainable:
            diags.append(Diagnostic(
                "regularizer-non-trainable",
                f"parameter {name!r} is non-trainable but carries a regularizer; the "
                "optimizer will never apply it",
                severity=WARNING, where=name))

    # -- state
    if train:
        for name in sorted(set(state) - updated):
            diags.append(Diagnostic(
                "stale-state",
                f"state entry {name!r} was created but never updated by a training-mode "
                "apply — a moving statistic that never moves",
                severity=WARNING, where=name))
    for scoped, bare in sorted(cross_scope):
        diags.append(Diagnostic(
            "cross-scope-state",
            f"update_state({bare!r}) inside scope {scoped.rsplit('/', 1)[0]!r} resolved "
            "through the bare-name fallback; address state within the name_scope that "
            "created it",
            severity=WARNING, where=scoped))

    # -- float64 in state and outputs
    for name, s in sorted(state.items()):
        if _is_f64(getattr(s, "dtype", None)):
            diags.append(Diagnostic("float64-leak", f"state entry {name!r} is float64",
                                    where=name))
    for i, leaf in enumerate(tree_mod.leaves(out[0])):
        if _is_f64(getattr(leaf, "dtype", None)):
            diags.append(Diagnostic(
                "float64-leak",
                f"model output {i} has dtype float64 — a float64 input or constant was "
                "promoted through the model (f64 runs far below the card's f32/bf16 rates)",
                where=f"{model.name}.apply output {i}"))
    return diags

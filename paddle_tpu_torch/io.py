"""Model persistence: parameters — port of ``paddle_tpu/io.py``.

Reference: ``python/paddle/fluid/io.py:89-506`` (save/load_vars/params/
persistables via save/load ops). Parameters serialize as the JAX package's
flat name→array archive (``params.npz`` + ``state.npz`` + a JSON
``manifest.json`` with dtype/shape/framework version), so either package
loads the other's. ``save_inference_model`` (a StableHLO export in the JAX
package) waits for its own slice (``ROADMAP.md``).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.convert import params_from_jax, params_to_numpy
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.framework import Variables
from paddle_tpu_torch.version import __version__

__all__ = ["save_params", "load_params", "save_persistables", "load_persistables",
           "save_vars", "load_vars"]

_MANIFEST = "manifest.json"
_PARAMS_FILE = "params.npz"
_STATE_FILE = "state.npz"


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

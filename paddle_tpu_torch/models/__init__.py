"""Model zoo — ``get_model(name, **cfg) -> ModelSpec``, as in
``paddle_tpu.models``. Ported so far: ``mnist`` and ``transformer_lm``."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np

from paddle_tpu_torch.framework import Model

__all__ = ["ModelSpec", "get_model", "MODELS"]


@dataclasses.dataclass
class ModelSpec:
    """A runnable benchmark config (get_model protocol)."""

    name: str
    model: Model
    # synth_batch(batch_size, rng) -> tuple of tensors fed to model.init/apply
    synth_batch: Callable[[int, np.random.RandomState], Tuple[Any, ...]]
    optimizer: Callable[[], Any]
    unit: str = "examples/sec"
    # elements counted per batch row for throughput (e.g. tokens per sentence)
    examples_per_row: int = 1
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def get_model(name: str, **cfg) -> ModelSpec:
    """Look up and instantiate a model by reference name."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name](**cfg)


def _mnist(**cfg):
    from paddle_tpu_torch.models import mnist

    return mnist.get_model(**cfg)


def _transformer_lm(**cfg):
    from paddle_tpu_torch.models import transformer_lm

    return transformer_lm.get_model(**cfg)


MODELS: Dict[str, Callable[..., ModelSpec]] = {
    "mnist": _mnist,
    "transformer_lm": _transformer_lm,
}

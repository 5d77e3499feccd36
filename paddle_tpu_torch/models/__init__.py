"""Model zoo — ``get_model(name, **cfg) -> ModelSpec``, as in
``paddle_tpu.models``: all eight of its models — ``mnist``, ``resnet``,
``se_resnext``, ``vgg``, ``transformer`` (the NMT encoder-decoder),
``transformer_lm``, ``stacked_dynamic_lstm`` and ``machine_translation``
(with its beam-search inference model, ``extra["make_infer_model"]``)."""

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


def _resnet(**cfg):
    from paddle_tpu_torch.models import resnet

    return resnet.get_model(**cfg)


def _se_resnext(**cfg):
    from paddle_tpu_torch.models import se_resnext

    return se_resnext.get_model(**cfg)


def _vgg(**cfg):
    from paddle_tpu_torch.models import vgg

    return vgg.get_model(**cfg)


def _transformer(**cfg):
    from paddle_tpu_torch.models import transformer

    return transformer.get_model(**cfg)


def _stacked_lstm(**cfg):
    from paddle_tpu_torch.models import stacked_lstm

    return stacked_lstm.get_model(**cfg)


def _machine_translation(**cfg):
    from paddle_tpu_torch.models import machine_translation

    return machine_translation.get_model(**cfg)


def _transformer_lm(**cfg):
    from paddle_tpu_torch.models import transformer_lm

    return transformer_lm.get_model(**cfg)


MODELS: Dict[str, Callable[..., ModelSpec]] = {
    "mnist": _mnist,
    "resnet": _resnet,
    "se_resnext": _se_resnext,
    "vgg": _vgg,
    "transformer": _transformer,
    "transformer_lm": _transformer_lm,
    "stacked_dynamic_lstm": _stacked_lstm,
    "machine_translation": _machine_translation,
}

"""High-level Inferencer, port of ``paddle_tpu/inferencer.py`` (reference
``python/paddle/fluid/inferencer.py``: Inferencer(infer_func, param_path,
place) loads trained params and serves ``infer(feed)`` through a prepared
executor).

The infer function is built into a :class:`Model`, params load from a
``save_params`` directory onto the place's device (CUDA unless the caller
asks for the CPU), and inference runs through the
:class:`paddle_tpu_torch.executor.Executor`'s prepared-function cache under
``torch.no_grad``. For sustained concurrent traffic, :meth:`as_engine`
upgrades this one-shot client into a
:class:`paddle_tpu_torch.serving.ServingEngine`."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from paddle_tpu_torch import io as io_mod
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.framework import Model, build

__all__ = ["Inferencer"]


class Inferencer:
    def __init__(
        self,
        infer_func: Callable,
        param_path: str,
        place=None,
        feed_order: Optional[Sequence[Any]] = None,
    ):
        """``feed_order``: optional FeedSpec list (or slot-name list) fixing
        the positional order dict feeds are unpacked in — the reference's
        feed-target names. Without it, dict feeds fall back to insertion
        order. ``place``: ``"cuda"`` (the default) or ``"cpu"``."""
        model = infer_func() if _takes_no_inputs(infer_func) else infer_func
        self.model = model if isinstance(model, Model) else build(model)
        self.place = place if place is not None else "cuda"
        self._exe = Executor(self.place)
        self.variables = io_mod.load_params(param_path, device=self._exe.device)
        self.feed_order = (
            [getattr(s, "name", s) for s in feed_order] if feed_order else None
        )

        def _fwd(variables, *args):
            out, _ = self.model.apply(variables, *args, is_train=False)
            return out

        self._fwd = _fwd

    def _ordered(self, feed: dict) -> list:
        if self.feed_order is None:
            return list(feed.values())  # legacy: raw insertion order
        missing = [n for n in self.feed_order if n not in feed]
        enforce(not missing, f"feed missing slots {missing}")
        return [feed[n] for n in self.feed_order]

    def infer(self, inputs):
        """Run inference on positional inputs (list/tuple, or a {name: value}
        dict — unpacked in ``feed_order`` when given, else insertion
        order). Batched arrays pass straight through; the outputs stay on
        the device."""
        if isinstance(inputs, dict):
            inputs = self._ordered(inputs)
        enforce(isinstance(inputs, (list, tuple)), "inputs must be a sequence or dict")
        compiled = self._exe.prepare(self._fwd, key=("inferencer", id(self)))
        with torch.no_grad():
            return compiled(self.variables, *self._exe.put(list(inputs)))

    @property
    def executor(self) -> Executor:
        """The executor whose prepared-function cache runs :meth:`infer`."""
        return self._exe

    def as_engine(self, feed_specs, config=None):
        """Upgrade to a dynamically-batched serving engine (the Inferencer
        is the one-shot client; the engine is the production path)."""
        from paddle_tpu_torch.serving import ServingEngine

        return ServingEngine(
            self.model,
            self.variables,
            feed_specs,
            config=config,
            place=self.place,
        )


def _takes_no_inputs(fn: Callable) -> bool:
    """Reference infer_funcs take no args and build the net via layer calls;
    plain net fns take the input tensors. Distinguish by arity."""
    import inspect

    try:
        return len(inspect.signature(fn).parameters) == 0
    except (TypeError, ValueError):
        return False

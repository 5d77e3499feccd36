"""Weighted average accumulator (a copy of ``paddle_tpu.average``; reference
``python/paddle/fluid/average.py`` WeightedAverage — used by book tests to
average per-batch losses)."""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight=1.0):
        self.numerator += float(np.sum(value)) * float(weight)
        self.denominator += float(weight)

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError("WeightedAverage has no accumulated values")
        return self.numerator / self.denominator

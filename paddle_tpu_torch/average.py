"""WeightedAverage (counterpart of ``paddle_tpu/average.py``; reference
average.py): a streaming weighted mean that training loops use to smooth
fetched losses."""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight):
        if not isinstance(value, (int, float)):
            arr = np.asarray(value).reshape(-1)
            if arr.size != 1:
                raise ValueError(
                    "WeightedAverage.add expects a scalar; got shape "
                    f"{np.asarray(value).shape} — reduce it first")
            value = float(arr[0])
        self.numerator += float(value) * weight
        self.denominator += weight

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError(
                "WeightedAverage.eval with nothing accumulated")
        return self.numerator / self.denominator

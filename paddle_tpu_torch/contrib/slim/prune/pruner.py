"""Weight pruners (reference contrib/slim/prune/pruner.py:21 Pruner,
MagnitudePruner:33, RatioPruner:50). Each emits a keep-mask variable with
layers ops in the caller's program.

As in the JAX package, the mask keeps the weights of largest magnitude:
``|w| > threshold`` for MagnitudePruner, and the top ``ratio`` fraction
by |w| for RatioPruner (ties at the threshold keep more). The reference's
literal ``less_than(param, threshold)`` keeps the small values and never
takes |w|."""

from __future__ import annotations

import numpy as np

from .... import layers

__all__ = ["Pruner", "MagnitudePruner", "RatioPruner"]


class Pruner:
    """Base class of the pruners: prune(param) -> keep-mask variable."""

    def prune(self, param):
        raise NotImplementedError


class MagnitudePruner(Pruner):
    """Keep the weights with |w| > threshold."""

    def __init__(self, threshold):
        self.threshold = threshold

    def prune(self, param, threshold=None):
        if threshold is None:
            thres = layers.fill_constant(shape=[1], dtype="float32",
                                         value=self.threshold)
        else:
            thres = threshold
        keep = layers.less_than(x=thres, y=layers.abs(param))
        return layers.cast(keep, "float32")


class RatioPruner(Pruner):
    """Keep the top ``ratio`` fraction of each parameter by |value|
    (ratios by parameter name, '*' the default; 0.4 prunes 60%)."""

    def __init__(self, ratios=None):
        self.ratios = ratios or {}

    def prune(self, param, ratio=None):
        if ratio is None:
            rat = self.ratios.get(param.name, self.ratios.get("*", 1.0))
        else:
            rat = ratio
        if rat >= 1.0:
            return layers.ones(param.shape, "float32")
        k = max(int(rat * int(np.prod(param.shape))), 1)
        flat = layers.reshape(x=layers.abs(param), shape=[1, -1])
        topk, _ = layers.topk(flat, k=k)
        thres = layers.slice(topk, axes=[1], starts=[k - 1], ends=[k])
        thres = layers.reshape(x=thres, shape=[1])
        # |w| >= the k-th largest: at least k survive
        keep = layers.logical_not(layers.less_than(x=layers.abs(param),
                                                   y=thres))
        return layers.cast(keep, "float32")

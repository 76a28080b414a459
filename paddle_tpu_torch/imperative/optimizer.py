"""Eager optimizers for dygraph training (counterpart of
``paddle_tpu/imperative/optimizer.py``): the update arithmetic of
operators/optimizers/sgd_op.cc and adam_op.h applied to ``VarBase``
parameters after the backward, in place and without autograd."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .tracer import VarBase


class SGDOptimizer:
    def __init__(self, learning_rate: float = 0.01):
        self.lr = learning_rate

    @torch.no_grad()
    def _step(self, parameter_list):
        for p in parameter_list or []:
            g = p._grad
            if g is None:
                continue
            p.array.sub_(self.lr * g)
            p.clear_gradient()

    def minimize(self, loss: VarBase,
                 parameter_list: Optional[List[VarBase]] = None):
        loss.backward()
        self._step(parameter_list)


class AdamOptimizer:
    def __init__(self, learning_rate: float = 1e-3, beta1=0.9,
                 beta2=0.999, epsilon=1e-8):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        self._m: Dict[int, torch.Tensor] = {}
        self._v: Dict[int, torch.Tensor] = {}
        self._t = 0

    @torch.no_grad()
    def _step(self, parameter_list):
        self._t += 1
        t = self._t
        for p in parameter_list or []:
            g = p._grad
            if g is None:
                continue
            m = self._m.get(id(p))
            v = self._v.get(id(p))
            if m is None:
                m = torch.zeros_like(p.array)
                v = torch.zeros_like(p.array)
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            mhat = m / (1 - self.b1 ** t)
            vhat = v / (1 - self.b2 ** t)
            p.array.sub_(self.lr * mhat / (torch.sqrt(vhat) + self.eps))
            self._m[id(p)] = m
            self._v[id(p)] = v
            p.clear_gradient()

    def minimize(self, loss: VarBase,
                 parameter_list: Optional[List[VarBase]] = None):
        loss.backward()
        self._step(parameter_list)

"""Weight decay appended as grad ops (counterpart of
``paddle_tpu/regularizer.py``; reference python/paddle/fluid/
regularizer.py): L2 adds coeff * param to the gradient, L1 adds coeff *
sign(param), each through one ``sum`` op. A parameter's own regularizer
wins over the optimizer's."""

from __future__ import annotations

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from .layers import nn
        decay = nn.scale(param, scale=self._coeff)
        out = block.create_var(dtype=grad.dtype, shape=grad.shape)
        block.append_op(type="sum", inputs={"X": [grad, decay]},
                        outputs={"Out": out})
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from .layers import nn
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="sign", inputs={"X": param},
                        outputs={"Out": sign})
        decay = nn.scale(sign, scale=self._coeff)
        out = block.create_var(dtype=grad.dtype, shape=grad.shape)
        block.append_op(type="sum", inputs={"X": [grad, decay]},
                        outputs={"Out": out})
        return out


def append_regularization_ops(parameters_and_grads, regularization=None):
    """The (param, grad) pairs with each gradient replaced by its decayed
    sum, under the OPTIMIZE role, where the parameter or the optimizer
    names a regularizer."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularizer = getattr(param, "regularizer", None) or regularization
        if grad is None or regularizer is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        with block.program._optimized_guard([param, grad]):
            new_grad = regularizer(param, grad, block)
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer

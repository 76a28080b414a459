"""Unary layers (reference python/paddle/fluid/layers/ops.py, which
generates wrappers from the registered OpProtos): one layer per activation
op of ``_UNARY_OPS``, made from its name as the JAX package makes it, plus
``pow`` and the random fills ``uniform_random`` and ``gaussian_random``."""

from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "log", "tanh", "tanh_shrink",
    "softshrink",
    "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round",
    "reciprocal", "square", "softplus", "softsign", "brelu", "leaky_relu",
    "soft_relu", "elu", "relu6", "swish", "hard_sigmoid", "hard_swish",
    "thresholded_relu", "stanh", "gelu",
]

__all__ = list(_UNARY_OPS) + ["pow", "uniform_random", "gaussian_random"]


def _make_layer(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": x},
                         outputs={"Out": out}, attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"{op_type} activation (activation_op.cc family)."
    return layer


for _op in _UNARY_OPS:
    globals()[_op] = _make_layer(_op)


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pow", inputs={"X": x}, outputs={"Out": out},
                     attrs={"factor": float(factor)})
    return out



def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="uniform_random", outputs={"Out": out},
                     attrs={"shape": list(shape), "min": float(min),
                            "max": float(max), "seed": seed,
                            "dtype": out.dtype})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gaussian_random", outputs={"Out": out},
                     attrs={"shape": list(shape), "mean": float(mean),
                            "std": float(std), "seed": seed,
                            "dtype": out.dtype})
    return out

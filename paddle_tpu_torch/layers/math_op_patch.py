"""Operator overloads of Variables (reference layers/math_op_patch.py):
``var + 1.0``, ``2.0 * var``, ``a / b`` append the elementwise ops the
JAX package appends, so the programs serialize to the same bytes."""

from __future__ import annotations


def binary_op(var, other, op_type, reverse=False):
    """``var <op> other`` (``other <op> var`` when ``reverse``). A number
    on the right of + or * becomes a ``scale``; any other number a [1]
    ``fill_constant`` in var's dtype."""
    from ..framework import Variable
    from ..layer_helper import LayerHelper
    from . import nn
    from . import tensor as tensor_layers

    helper = LayerHelper(op_type)
    if not isinstance(other, Variable):
        if op_type == "elementwise_add" and not reverse:
            return nn.scale(var, scale=1.0, bias=float(other))
        if op_type == "elementwise_mul" and not reverse:
            return nn.scale(var, scale=float(other))
        other = tensor_layers.fill_constant(shape=[1], dtype=var.dtype,
                                            value=float(other))
    x, y = (other, var) if reverse else (var, other)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": -1})
    return out

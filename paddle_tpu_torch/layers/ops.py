"""Unary layers (reference python/paddle/fluid/layers/ops.py): ``pow``,
the one the noam schedule calls."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["pow"]


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pow", inputs={"X": x}, outputs={"Out": out},
                     attrs={"factor": float(factor)})
    return out

"""Control-flow layers (reference python/paddle/fluid/layers/
control_flow.py): ``Print`` only."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["Print"]


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """control_flow.py Print (print_op.cc): a host op that prints
    ``input`` when the program runs; the input flows through unchanged.
    A block holding it runs in device segments split at the op."""
    helper = LayerHelper("print")
    helper.append_op(
        type="print", inputs={"In": input}, outputs={},
        attrs={"first_n": first_n, "message": message or "",
               "summarize": summarize,
               "print_tensor_name": print_tensor_name,
               "print_tensor_type": print_tensor_type,
               "print_tensor_shape": print_tensor_shape,
               "print_phase": print_phase})
    return input

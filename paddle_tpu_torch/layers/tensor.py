"""Tensor layers (reference python/paddle/fluid/layers/tensor.py)."""

from __future__ import annotations

import numpy as np

from ..core.types import convert_dtype
from ..framework import Variable
from ..layer_helper import LayerHelper, ParamAttr

# the JAX package's tensor.__all__
__all__ = ["create_tensor", "create_parameter", "create_global_var", "cast",
           "reverse", "tensor_array_to_tensor", "has_inf", "has_nan", "isfinite",
           "concat", "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "ones", "zeros",
           "zeros_like", "argmax", "argmin", "argsort"]


def create_tensor(dtype, name=None, persistable=False):
    """A variable of the global block, with no op writing it yet."""
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_global_variable(name=helper.name, dtype=dtype,
                                         persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A variable of the global block that the startup program fills with
    ``value``."""
    from ..initializer import ConstantInitializer
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        name=name, dtype=dtype, shape=shape, persistable=persistable)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"in_dtype": x.dtype,
                            "out_dtype": convert_dtype(dtype)})
    return out


def concat(input, axis=0, name=None):
    from . import nn
    return nn.concat(input, axis, name)


def sums(input, out=None):
    """The elementwise sum of the variables in ``input`` (one ``sum``
    op)."""
    helper = LayerHelper("sum")
    out = out or helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": out})
    return out


def assign(input, output=None):
    """Copy a Variable (``assign``) or write a numpy literal into the
    program (``assign_value``, the values flat in the attrs)."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        output = output or helper.create_variable_for_type_inference(
            input.dtype)
        helper.append_op(type="assign", inputs={"X": input},
                         outputs={"Out": output})
    else:
        arr = np.asarray(input)
        output = output or helper.create_variable_for_type_inference(
            str(arr.dtype))
        helper.append_op(
            type="assign_value", outputs={"Out": output},
            attrs={"shape": list(arr.shape), "dtype": convert_dtype(
                str(arr.dtype)), "values": arr.reshape(-1).tolist()})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    out = out or helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant", outputs={"Out": out},
        attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
               "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """fill_constant whose dim ``output_dim_idx`` is ``input``'s dim
    ``input_dim_idx`` at run time (the batch of a dynamic-batch var)."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": input}, outputs={"Out": out},
        attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter of ``shape``; an explicit ``name`` is used verbatim
    (reference tensor.py: ``ParamAttr(name=name)``)."""
    helper = LayerHelper("create_parameter", name=name)
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def tensor_array_to_tensor(input, axis=1, use_stack=False, name=None):
    """The array's tensors concatenated (or stacked) along ``axis``;
    returns (out, out_index), out_index their extents along it."""
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_index = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="tensor_array_to_tensor",
                     inputs={"X": input},
                     outputs={"Out": out, "OutIndex": out_index},
                     attrs={"axis": axis, "use_stack": use_stack})
    return out, out_index


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    out = out or helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": x},
                     outputs={"Out": out})
    return out


def argmax(x, axis=0):
    from . import nn
    return nn.arg_max(x, axis)


def argmin(x, axis=0):
    from . import nn
    return nn.arg_min(x, axis)


def argsort(x, axis=-1, name=None):
    from . import nn
    return nn.argsort(x, axis, name)


def _overflow_check(op_type, x, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type=op_type, inputs={"X": x}, outputs={"Out": out})
    return out


def has_inf(x, name=None):
    """Whether any element of ``x`` is infinite (isfinite_op.cc family)."""
    return _overflow_check("has_inf", x, name)


def has_nan(x, name=None):
    return _overflow_check("has_nan", x, name)


def isfinite(x, name=None):
    return _overflow_check("isfinite", x, name)


def reverse(x, axis):
    """x flipped along ``axis`` (an int or a list)."""
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    if isinstance(axis, int):
        axis = [axis]
    helper.append_op(type="reverse", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": list(axis)})
    return out

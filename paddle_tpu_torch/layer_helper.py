"""LayerHelper: shared machinery for layer functions (reference
python/paddle/fluid/layer_helper.py). Creates parameters in both
programs (startup: creation + init op; main: the var itself), creates
temp output vars, appends ops, and applies the bias/act conveniences."""

from __future__ import annotations

from .framework import (Parameter, Variable, default_main_program,
                        default_startup_program)
from .initializer import ConstantInitializer, Initializer, XavierInitializer
from .utils import unique_name


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if arg is False:
            return False
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")


class WeightNormParamAttr(ParamAttr):
    """A parameter reparameterized as w = g * v / ||v|| (Salimans and
    Kingma, arXiv:1602.07868), the norm over every axis but ``dim``
    (``dim=None``: one norm). v and g are the trainable parameters; the
    layer reads the recomposed w."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 gradient_clip=None, do_model_average=False):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable,
                         gradient_clip=gradient_clip,
                         do_model_average=do_model_average)
        self.dim = dim


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        self.name = kwargs.get("name") or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None) -> Parameter:
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if isinstance(attr, WeightNormParamAttr):
            return self._create_weight_normalized(
                attr, shape, dtype, default_initializer)
        # reference naming convention: weights `<layer>.w_N`, biases
        # `<layer>.b_N`
        name = attr.name or unique_name.generate(
            f"{self.name}.b" if is_bias else f"{self.name}.w")
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer())
        kwargs = dict(trainable=attr.trainable, regularizer=attr.regularizer,
                      gradient_clip_attr=attr.gradient_clip,
                      optimize_attr={"learning_rate": attr.learning_rate},
                      do_model_average=attr.do_model_average)
        startup_block = self.startup_program.global_block()
        sp = startup_block.create_parameter(name=name, shape=shape,
                                            dtype=dtype, **kwargs)
        init(sp, startup_block)
        return self.main_program.global_block().create_parameter(
            name=name, shape=shape, dtype=dtype, **kwargs)

    def _create_weight_normalized(self, attr, shape, dtype,
                                  default_initializer):
        """The parameters v and g (``<v>@wn.g``, set to ||v|| by the
        startup program after v's initializer, so the first forward reads
        the plain initialization) and the ops that recompose w = v g /
        ||v|| in the main program; returns w."""
        dim = attr.dim
        if dim is not None and dim < 0:
            dim += len(shape)
        reduce_dims = [i for i in range(len(shape)) if i != dim]
        g_shape = [1] if dim is None else [int(shape[dim])]
        bcast_axis = -1 if dim is None else dim
        v = self.create_parameter(
            ParamAttr(name=attr.name, initializer=attr.initializer,
                      learning_rate=attr.learning_rate,
                      regularizer=attr.regularizer, trainable=attr.trainable,
                      gradient_clip=attr.gradient_clip,
                      do_model_average=attr.do_model_average),
            shape, dtype, default_initializer=default_initializer)
        # g is trained as v is: the regularizer, clip and averaging apply
        # to both halves
        g = self.create_parameter(
            ParamAttr(name=f"{v.name}@wn.g", learning_rate=attr.learning_rate,
                      regularizer=attr.regularizer, trainable=attr.trainable,
                      gradient_clip=attr.gradient_clip,
                      do_model_average=attr.do_model_average),
            g_shape, dtype, default_initializer=ConstantInitializer(0.0))

        def norm_ops(block, v_name, out_name):
            sq = block.create_var(
                name=unique_name.generate(f"{self.name}.wn_sq"),
                dtype=dtype, stop_gradient=False)
            ssum = block.create_var(
                name=unique_name.generate(f"{self.name}.wn_ssum"),
                dtype=dtype, stop_gradient=False)
            block.append_op(type="square", inputs={"X": v_name},
                            outputs={"Out": sq})
            block.append_op(type="reduce_sum", inputs={"X": sq},
                            outputs={"Out": ssum},
                            attrs={"dim": reduce_dims, "keep_dim": False})
            block.append_op(type="sqrt", inputs={"X": ssum},
                            outputs={"Out": out_name})

        norm_ops(self.startup_program.global_block(), v.name, g.name)
        block = self.block
        norm = block.create_var(
            name=unique_name.generate(f"{self.name}.wn_norm"),
            dtype=dtype, stop_gradient=False)
        norm_ops(block, v.name, norm.name)
        ratio = block.create_var(
            name=unique_name.generate(f"{self.name}.wn_ratio"),
            dtype=dtype, stop_gradient=False)
        block.append_op(type="elementwise_div", inputs={"X": g, "Y": norm},
                        outputs={"Out": ratio}, attrs={"axis": -1})
        w = block.create_var(
            name=unique_name.generate(f"{self.name}.wn_w"),
            dtype=dtype, shape=list(shape), stop_gradient=False)
        block.append_op(type="elementwise_mul", inputs={"X": v, "Y": ratio},
                        outputs={"Out": w}, attrs={"axis": bcast_axis})
        return w

    def create_variable_for_type_inference(self, dtype,
                                           stop_gradient=False) -> Variable:
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_global_variable(self, name=None, persistable=False,
                               dtype="float32", shape=None,
                               stop_gradient=True) -> Variable:
        """A variable of the main program's global block (learning rate,
        optimizer state, step counter)."""
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(f"{self.name}.global"),
            dtype=dtype, shape=shape, persistable=persistable,
            stop_gradient=stop_gradient)

    def set_variable_initializer(self, var: Variable, initializer):
        """Initialize ``var`` in the startup program."""
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, dtype=var.dtype, shape=var.shape,
                           persistable=True, stop_gradient=True)
        initializer(sv, sb)

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def append_bias_op(self, input_var: Variable, dim_start=1,
                       dim_end=None) -> Variable:
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        tmp = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type="elementwise_add",
                       inputs={"X": input_var, "Y": b},
                       outputs={"Out": tmp}, attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var: Variable) -> Variable:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type=act_type, inputs={"X": input_var},
                       outputs={"Out": tmp}, attrs=act)
        return tmp

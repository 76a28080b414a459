"""Imperative Layer zoo (counterpart of ``paddle_tpu/imperative/layers.py``,
after imperative/layer.h:233 ``Layer`` and
python/paddle/fluid/imperative/nn.py: FC, Conv2D, Pool2D, BatchNorm,
Embedding). Parameters are ``VarBase`` leaves on the tracer's device,
owned by the Layer and drawn from numpy's global ``np.random`` as the JAX
package draws them, so one ``np.random.seed`` gives both packages the
same weights; forward passes dispatch through ``trace_op`` to the
registry's emitters.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from .tracer import VarBase, trace_op, _active_tracer


class Layer:
    """Parameter container with recursive sublayers."""

    def __init__(self, name_scope: str = ""):
        self._parameters: Dict[str, VarBase] = {}
        self._sub_layers: Dict[str, "Layer"] = {}
        self._name_scope = name_scope or type(self).__name__

    # attribute routing: assigning a VarBase/Layer registers it
    def __setattr__(self, k, v):
        params = self.__dict__.get("_parameters")
        subs = self.__dict__.get("_sub_layers")
        if params is not None and isinstance(v, VarBase):
            params[k] = v
        elif subs is not None and isinstance(v, Layer):
            subs[k] = v
        object.__setattr__(self, k, v)

    def create_parameter(self, name: str, shape, dtype="float32",
                         initializer=None, is_bias=False) -> VarBase:
        if initializer is not None:
            value = initializer(shape)
        elif is_bias:
            value = np.zeros(shape, dtype)
        else:
            fan_in = int(np.prod(shape[:-1])) or 1
            bound = float(np.sqrt(6.0 / (fan_in + int(shape[-1]))))
            value = np.random.uniform(-bound, bound, shape).astype(dtype)
        p = VarBase(value, stop_gradient=False,
                    name=f"{self._name_scope}.{name}")
        self._parameters[name] = p
        return p

    def parameters(self, include_sublayers=True) -> List[VarBase]:
        out = list(self._parameters.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                out.extend(l.parameters())
        return out

    def sublayers(self) -> Iterator["Layer"]:
        return iter(self._sub_layers.values())

    def train(self):
        _active_tracer().train_mode = True

    def eval(self):
        _active_tracer().train_mode = False

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    def forward(self, *args, **kw):
        raise NotImplementedError

    def __call__(self, *args, **kw):
        return self.forward(*args, **kw)


class PyLayer(Layer):
    """layer.h:191 PyLayer: the user supplies forward in Python; the
    gradient comes from autograd (no manual backward)."""


class FC(Layer):
    def __init__(self, size, num_flatten_dims=1, act=None,
                 name_scope="FC", dtype="float32"):
        super().__init__(name_scope)
        self._size = size
        self._ncol = num_flatten_dims
        self._act = act
        self._dtype = dtype
        self._w = None
        self._b = None

    def forward(self, input: VarBase) -> VarBase:
        if self._w is None:
            in_dim = int(np.prod(input.shape[self._ncol:]))
            self._w = self.create_parameter("w", [in_dim, self._size],
                                            self._dtype)
            self._b = self.create_parameter("b", [self._size], self._dtype,
                                            is_bias=True)
        out = trace_op("mul", {"X": [input], "Y": [self._w]},
                       {"x_num_col_dims": self._ncol,
                        "y_num_col_dims": 1})["Out"][0]
        out = trace_op("elementwise_add", {"X": [out], "Y": [self._b]},
                       {"axis": -1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Conv2D(Layer):
    def __init__(self, num_filters, filter_size, stride=1, padding=0,
                 act=None, name_scope="Conv2D", dtype="float32"):
        super().__init__(name_scope)
        self._nf = num_filters
        self._fs = ([filter_size] * 2 if isinstance(filter_size, int)
                    else list(filter_size))
        self._stride = [stride] * 2 if isinstance(stride, int) else stride
        self._pad = [padding] * 2 if isinstance(padding, int) else padding
        self._act = act
        self._dtype = dtype
        self._w = None
        self._b = None

    def forward(self, input: VarBase) -> VarBase:
        if self._w is None:
            cin = input.shape[1]
            std = (2.0 / (self._fs[0] * self._fs[1] * cin)) ** 0.5
            self._w = self.create_parameter(
                "w", [self._nf, cin] + self._fs, self._dtype,
                initializer=lambda s: np.random.normal(
                    0, std, s).astype(self._dtype))
            self._b = self.create_parameter("b", [self._nf], self._dtype,
                                            is_bias=True)
        out = trace_op("conv2d",
                       {"Input": [input], "Filter": [self._w]},
                       {"strides": self._stride, "paddings": self._pad,
                        "dilations": [1, 1], "groups": 1})["Output"][0]
        out = trace_op("elementwise_add", {"X": [out], "Y": [self._b]},
                       {"axis": 1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Pool2D(Layer):
    def __init__(self, pool_size=2, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False,
                 name_scope="Pool2D"):
        super().__init__(name_scope)
        self._attrs = {
            "ksize": [pool_size] * 2 if isinstance(pool_size, int)
            else pool_size,
            "pooling_type": pool_type,
            "strides": [pool_stride] * 2
            if isinstance(pool_stride, int) else pool_stride,
            "paddings": [pool_padding] * 2
            if isinstance(pool_padding, int) else pool_padding,
            "global_pooling": global_pooling,
        }

    def forward(self, input: VarBase) -> VarBase:
        return trace_op("pool2d", {"X": [input]}, self._attrs)["Out"][0]


class BatchNorm(Layer):
    """Eager batch_norm: the moving statistics are written back on the
    layer after each training call, detached (no autograd history)."""

    def __init__(self, num_channels, momentum=0.9, epsilon=1e-5, act=None,
                 name_scope="BatchNorm", dtype="float32"):
        super().__init__(name_scope)
        self._scale = self.create_parameter(
            "scale", [num_channels], dtype,
            initializer=lambda s: np.ones(s, dtype))
        self._bias = self.create_parameter("bias", [num_channels], dtype,
                                           is_bias=True)
        self._mean = VarBase(np.zeros(num_channels, dtype),
                             stop_gradient=True)
        self._var = VarBase(np.ones(num_channels, dtype),
                            stop_gradient=True)
        self._attrs = {"momentum": momentum, "epsilon": epsilon,
                       "data_layout": "NCHW", "use_global_stats": False}
        self._act = act

    def forward(self, input: VarBase) -> VarBase:
        attrs = dict(self._attrs,
                     is_test=not _active_tracer().train_mode)
        outs = trace_op(
            "batch_norm",
            {"X": [input], "Scale": [self._scale], "Bias": [self._bias],
             "Mean": [self._mean], "Variance": [self._var]}, attrs)
        if not attrs["is_test"]:
            self._mean.array = outs["MeanOut"][0].array
            self._var.array = outs["VarianceOut"][0].array
        out = outs["Y"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Embedding(Layer):
    def __init__(self, size, dtype="float32", name_scope="Embedding"):
        super().__init__(name_scope)
        self._w = self.create_parameter(
            "w", list(size), dtype,
            initializer=lambda s: np.random.normal(
                0, 0.02, s).astype(dtype))

    @property
    def weight(self):
        return self._w

    def forward(self, ids: VarBase) -> VarBase:
        ids = ids if isinstance(ids, VarBase) else VarBase(
            np.asarray(ids), stop_gradient=True)
        ids.stop_gradient = True
        return trace_op("lookup_table",
                        {"W": [self._w], "Ids": [ids]},
                        {"padding_idx": -1})["Out"][0]

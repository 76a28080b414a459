"""Quantization-aware training transpiler (counterpart of
``paddle_tpu/contrib/quantize.py``; reference
contrib/quantize/quantize_transpiler.py:81).

``training_transpile`` puts a fake-quant op in front of every input of
the quantizable ops (``mul``, ``conv2d``, ``depthwise_conv2d``, ``fc``):
``fake_quantize_abs_max`` on weights, the activation type asked for on
activations (the stateful ones keep their scale in a persistable that
starts at 0 in the global scope). ``freeze_program`` turns each weight's
quant op into an int8 persistable and a ``dequantize_weights`` op, and
the stateful quants into test mode (frozen scales). The programs are the
JAX package's, byte for byte; the int8 weights are computed in float64
numpy as the JAX package's are, so they are its, bit for bit. The quant
ops are ``ops/kernels_quant.py``'s.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.desc import OpDesc
from ..place import CUDAPlace

QUANTIZABLE_OP_TYPES = ("mul", "conv2d", "depthwise_conv2d", "fc")
# the slot holding the weight input of each quantizable op type
_WEIGHT_SLOT = {"mul": "Y", "conv2d": "Filter",
                "depthwise_conv2d": "Filter", "fc": "W"}
_ACT_SLOTS = {"mul": ("X",), "conv2d": ("Input",),
              "depthwise_conv2d": ("Input",), "fc": ("Input",)}


class QuantizeTranspiler:
    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 activation_quantize_type: str = "abs_max",
                 weight_quantize_type: str = "abs_max",
                 moving_rate: float = 0.9):
        if activation_quantize_type not in (
                "abs_max", "range_abs_max", "moving_average_abs_max"):
            raise ValueError(activation_quantize_type)
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_type = activation_quantize_type
        self.weight_type = weight_quantize_type
        self.moving_rate = moving_rate

    # ------------------------------------------------------------------
    def training_transpile(self, program=None, startup_program=None,
                           place=None):
        """Insert the fake-quant ops in front of every quantizable op
        (weights and activations); one quant op per input name, shared by
        every op that reads it. The stateful scales start at 0 on
        ``place`` (the card unless the caller passes another)."""
        from ..framework import default_main_program
        program = program or default_main_program()
        block = program.global_block()
        desc = block.desc
        quanted: Dict[str, str] = {}  # var -> its quantized name
        new_ops = []
        for op in desc.ops:
            if op.type in QUANTIZABLE_OP_TYPES:
                for slot in _ACT_SLOTS[op.type] + (_WEIGHT_SLOT[op.type],):
                    names = op.input(slot)
                    if not names:
                        continue
                    name = names[0]
                    vd = desc.vars.get(name)
                    if vd is None:
                        continue
                    qname = quanted.get(name)
                    if qname is None:
                        qname = name + ".quantized"
                        new_ops.extend(self._make_quant_ops(
                            block, name, qname, bool(vd.persistable),
                            place))
                        quanted[name] = qname
                    op.rename_input(name, qname)
            new_ops.append(op)
        desc.ops = new_ops
        program._bump()
        return program

    def _make_quant_ops(self, block, name, qname, is_weight, place):
        bits = self.weight_bits if is_weight else self.activation_bits
        src = block.desc.vars[name]
        block.create_var(name=qname, shape=src.shape, dtype=src.dtype)
        scale_name = name + ".quant_scale"
        qtype = "abs_max" if is_weight else self.act_type
        block.create_var(name=scale_name, shape=[1], dtype=src.dtype,
                         persistable=(qtype != "abs_max"))
        if qtype == "abs_max":
            return [OpDesc("fake_quantize_abs_max", {"X": [name]},
                           {"Out": [qname], "OutScale": [scale_name]},
                           {"bit_length": bits})]
        self._init_scale_var(scale_name, place)
        return [OpDesc(
            f"fake_quantize_{qtype}",
            {"X": [name], "InScale": [scale_name]},
            {"Out": [qname], "OutScale": [scale_name]},
            {"bit_length": bits, "moving_rate": self.moving_rate,
             "is_test": False})]

    @staticmethod
    def _init_scale_var(scale_name, place):
        from ..executor import global_scope
        scope = global_scope()
        if scope.find_var(scale_name) is None:
            device = (place or CUDAPlace(0)).torch_device
            scope.set_var(scale_name,
                          torch.zeros(1, dtype=torch.float32, device=device))

    # ------------------------------------------------------------------
    def freeze_program(self, program, place=None, scope=None):
        """Weights become int8 persistables read through
        ``dequantize_weights`` ops; the stateful activation quants flip to
        test mode (frozen scales). The int8 tensors and their scales go
        on ``place``, else on the device of the weight they replace."""
        from ..executor import global_scope
        scope = scope or global_scope()
        block = program.global_block()
        desc = block.desc
        new_ops = []
        for op in desc.ops:
            if op.type == "fake_quantize_abs_max":
                vd = desc.vars.get(op.input("X")[0])
                if vd is not None and vd.persistable:
                    new_ops.append(self._freeze_weight(block, scope, op,
                                                       place))
                    continue
            if op.type.startswith("fake_quantize_") and \
                    "InScale" in op.inputs:
                op.attrs["is_test"] = True
            new_ops.append(op)
        desc.ops = new_ops
        program._bump()
        return program

    def _freeze_weight(self, block, scope, op, place) -> OpDesc:
        """round(w / max|w| * qmax) in float64, clipped to +-qmax."""
        qmax = float(2 ** (self.weight_bits - 1) - 1)
        src = op.input("X")[0]
        qname = op.output("Out")[0]
        scale_name = op.output("OutScale")[0]
        t = scope.find_var(src)
        device = place.torch_device if place is not None else t.device
        w = t.detach().cpu().numpy().astype(np.float64)
        scale = float(np.abs(w).max()) or 1e-8
        w8 = np.clip(np.round(w / scale * qmax), -qmax, qmax).astype(
            np.int8)
        int8_name = src + ".int8"
        scope.set_var(int8_name, torch.from_numpy(w8).to(device))
        scope.set_var(scale_name, torch.tensor([scale], dtype=torch.float32,
                                               device=device))
        block.create_var(name=int8_name, shape=list(w.shape),
                         dtype="int8", persistable=True)
        block.desc.vars[scale_name].persistable = True
        if scale_name in block.vars:
            block.vars[scale_name].desc.persistable = True
        return OpDesc("dequantize_weights",
                      {"X": [int8_name], "Scale": [scale_name]},
                      {"Out": [qname]}, {"max_range": qmax})

    def convert_to_int8(self, program, place=None, scope=None):
        """The weight conversion alone (``freeze_program``)."""
        return self.freeze_program(program, place, scope)

"""Program IR descriptors.

Counterpart of ``paddle_tpu/core/desc.py``: a Program is a list of Blocks;
a Block is an ordered list of OpDescs plus a var table. The descriptors
are pure data. The port's executor interprets a BlockDesc op by op.

Serialization: ``ProgramDesc.to_bytes()/from_bytes()`` use the binary
codec of ``core/binary.py``, byte-compatible with the JAX package, so a
``__model__`` written by either package loads in the other.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional

from .types import DataType, VarType, convert_dtype

DESC_VERSION = 1


class VarDesc:
    __slots__ = ("name", "type", "dtype", "shape", "persistable",
                 "stop_gradient", "need_check_feed")

    def __init__(self, name: str, type: VarType = VarType.DENSE_TENSOR,
                 dtype: DataType = DataType.FP32,
                 shape: Optional[List[int]] = None,
                 persistable: bool = False, stop_gradient: bool = False):
        self.name = name
        self.type = VarType(type)
        self.dtype = convert_dtype(dtype) if dtype is not None else None
        self.shape = list(shape) if shape is not None else None
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.need_check_feed = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "type": int(self.type),
            "dtype": int(self.dtype) if self.dtype is not None else None,
            "shape": self.shape,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "VarDesc":
        return VarDesc(
            d["name"], VarType(d["type"]),
            DataType(d["dtype"]) if d["dtype"] is not None else None,
            d["shape"], d["persistable"], d["stop_gradient"])

    def __repr__(self):
        return (f"VarDesc({self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")


class OpDesc:
    """One operation: type + named input/output slots + attrs. Inputs
    and outputs map slot name -> [var names]."""

    __slots__ = ("type", "inputs", "outputs", "attrs", "callstack")

    def __init__(self, type: str,
                 inputs: Optional[Dict[str, List[str]]] = None,
                 outputs: Optional[Dict[str, List[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        # creation callstack (FLAGS_op_callstack), kept out of attrs so
        # the serialized desc does not depend on it
        self.callstack: Optional[List[str]] = None

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def rename_input(self, old: str, new: str):
        for ns in self.inputs.values():
            for i, n in enumerate(ns):
                if n == old:
                    ns[i] = new

    def to_dict(self) -> Dict[str, Any]:
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": _attrs_to_jsonable(self.attrs)}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OpDesc":
        return OpDesc(d["type"], d["inputs"], d["outputs"],
                      _attrs_from_jsonable(d["attrs"]))

    def __repr__(self):
        return f"OpDesc({self.type!r}, in={self.inputs}, out={self.outputs})"


def _ndarray_to_jsonable(v) -> Dict[str, Any]:
    """Jsonable form of a literal-valued ndarray attr, shared by the json
    codec below and binary.py's ATTR_JSON path."""
    return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}


def _ndarray_from_jsonable(d: Dict[str, Any]):
    import numpy as np
    return np.array(d["__ndarray__"], dtype=d["dtype"])


def _attrs_to_jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    import numpy as np
    out = {}
    for k, v in attrs.items():
        if isinstance(v, DataType):
            out[k] = {"__dtype__": int(v)}
        elif isinstance(v, VarType):
            out[k] = {"__vartype__": int(v)}
        elif isinstance(v, np.ndarray):
            out[k] = _ndarray_to_jsonable(v)
        elif isinstance(v, (list, tuple)):
            out[k] = list(v)
        elif isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        else:
            out[k] = {"__repr__": repr(v)}
    return out


def _attrs_from_jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__dtype__" in v:
            out[k] = DataType(v["__dtype__"])
        elif isinstance(v, dict) and "__vartype__" in v:
            out[k] = VarType(v["__vartype__"])
        elif isinstance(v, dict) and "__ndarray__" in v:
            out[k] = _ndarray_from_jsonable(v)
        else:
            out[k] = v
    return out


class BlockDesc:
    __slots__ = ("idx", "parent_idx", "vars", "ops", "forward_block_idx")

    def __init__(self, idx: int, parent_idx: int = -1):
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, VarDesc] = {}
        self.ops: List[OpDesc] = []
        self.forward_block_idx = -1

    def append_op(self, op: OpDesc) -> OpDesc:
        self.ops.append(op)
        return op

    def prepend_op(self, op: OpDesc) -> OpDesc:
        self.ops.insert(0, op)
        return op

    def to_dict(self) -> Dict[str, Any]:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [o.to_dict() for o in self.ops],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "BlockDesc":
        b = BlockDesc(d["idx"], d["parent_idx"])
        b.forward_block_idx = d.get("forward_block_idx", -1)
        for vd in d["vars"]:
            v = VarDesc.from_dict(vd)
            b.vars[v.name] = v
        b.ops = [OpDesc.from_dict(od) for od in d["ops"]]
        return b


class ProgramDesc:
    __slots__ = ("blocks", "version")

    def __init__(self):
        self.version = DESC_VERSION
        self.blocks: List[BlockDesc] = [BlockDesc(0)]

    def num_blocks(self) -> int:
        return len(self.blocks)

    def append_block(self, parent_idx: int) -> BlockDesc:
        b = BlockDesc(len(self.blocks), parent_idx)
        self.blocks.append(b)
        return b

    def clone(self) -> "ProgramDesc":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {"version": self.version,
                "blocks": [b.to_dict() for b in self.blocks]}

    def to_bytes(self) -> bytes:
        """Compact binary form (core/binary.py)."""
        from . import binary
        return binary.encode_program(self)

    def to_json_bytes(self) -> bytes:
        return json.dumps(self.to_dict(), separators=(",", ":")).encode("utf-8")

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ProgramDesc":
        p = ProgramDesc()
        p.version = d.get("version", DESC_VERSION)
        p.blocks = [BlockDesc.from_dict(bd) for bd in d["blocks"]]
        return p

    @staticmethod
    def from_bytes(data: bytes) -> "ProgramDesc":
        from . import binary
        if binary.is_binary_program(data):
            return binary.decode_program(data)
        return ProgramDesc.from_dict(json.loads(data.decode("utf-8")))

"""Core type system for the Program IR.

Counterpart of ``paddle_tpu/core/types.py``: the same enums with the same
serialized values, so a ProgramDesc written by either package reads in the
other. Element dtypes map onto torch dtypes (``dtype_to_torch``); numpy has
no bfloat16, so host-side arrays of that type travel as torch tensors.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class VarType(enum.IntEnum):
    """Variable kinds (reference framework.proto:105)."""

    DENSE_TENSOR = 0
    SELECTED_ROWS = 1
    STEP_SCOPES = 2
    TENSOR_ARRAY = 3
    READER = 4
    RAW = 5


class DataType(enum.IntEnum):
    """Element dtypes; values are stable for serialization."""

    BOOL = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    FP16 = 5
    FP32 = 6
    FP64 = 7
    UINT8 = 8
    BF16 = 9


_DTYPE_TO_NP = {
    DataType.BOOL: np.dtype("bool"),
    DataType.INT8: np.dtype("int8"),
    DataType.INT16: np.dtype("int16"),
    DataType.INT32: np.dtype("int32"),
    DataType.INT64: np.dtype("int64"),
    DataType.FP16: np.dtype("float16"),
    DataType.FP32: np.dtype("float32"),
    DataType.FP64: np.dtype("float64"),
    DataType.UINT8: np.dtype("uint8"),
}

_NP_TO_DTYPE = {v: k for k, v in _DTYPE_TO_NP.items()}

_DTYPE_TO_TORCH = {
    DataType.BOOL: torch.bool,
    DataType.INT8: torch.int8,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FP16: torch.float16,
    DataType.FP32: torch.float32,
    DataType.FP64: torch.float64,
    DataType.UINT8: torch.uint8,
    DataType.BF16: torch.bfloat16,
}

_TORCH_TO_DTYPE = {v: k for k, v in _DTYPE_TO_TORCH.items()}

_STR_ALIASES = {
    "bool": DataType.BOOL,
    "int8": DataType.INT8,
    "int16": DataType.INT16,
    "int32": DataType.INT32,
    "int64": DataType.INT64,
    "float16": DataType.FP16,
    "fp16": DataType.FP16,
    "half": DataType.FP16,
    "float32": DataType.FP32,
    "fp32": DataType.FP32,
    "float": DataType.FP32,
    "float64": DataType.FP64,
    "fp64": DataType.FP64,
    "double": DataType.FP64,
    "uint8": DataType.UINT8,
    "bfloat16": DataType.BF16,
    "bf16": DataType.BF16,
}


def convert_dtype(dtype) -> DataType:
    """Coerce a string / numpy dtype / torch dtype / DataType into a
    DataType."""
    if isinstance(dtype, DataType):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _STR_ALIASES:
            return _STR_ALIASES[key]
        raise ValueError(f"unknown dtype string: {dtype!r}")
    if isinstance(dtype, torch.dtype):
        if dtype in _TORCH_TO_DTYPE:
            return _TORCH_TO_DTYPE[dtype]
        raise ValueError(f"unsupported dtype: {dtype!r}")
    npdt = np.dtype(dtype) if not hasattr(dtype, "name") else np.dtype(dtype.name)
    if npdt in _NP_TO_DTYPE:
        return _NP_TO_DTYPE[npdt]
    raise ValueError(f"unsupported dtype: {dtype!r}")


def dtype_to_torch(dtype) -> torch.dtype:
    return _DTYPE_TO_TORCH[convert_dtype(dtype)]


def dtype_to_str(dtype) -> str:
    dtype = convert_dtype(dtype)
    if dtype == DataType.BF16:
        return "bfloat16"
    return dtype_to_numpy(dtype).name


def dtype_to_numpy(dtype):
    """DataType -> numpy dtype. bfloat16 has none: use dtype_to_torch."""
    dtype = convert_dtype(dtype)
    if dtype == DataType.BF16:
        raise ValueError("numpy has no bfloat16; use dtype_to_torch")
    return _DTYPE_TO_NP[dtype]


class OpRole(enum.IntEnum):
    """Role attr stamped on every op by the frontend (reference
    framework.py ``op_role``)."""

    FORWARD = 0
    BACKWARD = 1
    OPTIMIZE = 2
    RPC = 3
    DIST = 4
    LRSCHED = 16
    LOSS = 256


OP_ROLE_ATTR_NAME = "op_role"
OP_ROLE_VAR_ATTR_NAME = "op_role_var"
GRAD_SUFFIX = "@GRAD"

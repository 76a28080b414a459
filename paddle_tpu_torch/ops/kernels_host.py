"""Host ops: save/load and save_combine/load_combine (checkpointing as
ops), and print.

Counterpart of ``paddle_tpu/ops/kernels_host.py`` with the same tensor
file format, so parameter files cross-load between the two packages: a
small JSON header (shape, dtype, version) + raw little-endian bytes.
bfloat16 payloads are raw uint16 words.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from ..registry import register_op

MAGIC = b"PTPU"
VERSION = 1


def _write_tensor(f, t):
    t = torch.as_tensor(t).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        dt_name = "bfloat16"
        raw = t.view(torch.int16).numpy().tobytes()
    else:
        arr = t.numpy()
        dt_name = arr.dtype.name
        raw = arr.tobytes()
    header = json.dumps({"shape": list(t.shape), "dtype": dt_name,
                         "version": VERSION}).encode()
    f.write(MAGIC)
    f.write(struct.pack("<I", len(header)))
    f.write(header)
    f.write(raw)


def _read_tensor(f) -> torch.Tensor:
    if f.read(4) != MAGIC:
        raise ValueError("bad tensor file magic")
    (hlen,) = struct.unpack("<I", f.read(4))
    header = json.loads(f.read(hlen).decode())
    shape = tuple(header["shape"])
    n = int(np.prod(shape)) if shape else 1
    if header["dtype"] == "bfloat16":
        raw = np.frombuffer(f.read(2 * n), dtype=np.int16).copy()
        return torch.from_numpy(raw).view(torch.bfloat16).reshape(shape)
    dt = np.dtype(header["dtype"])
    raw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt).copy()
    return torch.from_numpy(raw).reshape(shape)


def save_tensor_to_file(path: str, t):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        _write_tensor(f, t)


def load_tensor_from_file(path: str) -> torch.Tensor:
    with open(path, "rb") as f:
        return _read_tensor(f)


@register_op("save", no_grad=True, is_host=True)
def save(ctx, ins, attrs):
    save_tensor_to_file(attrs["file_path"], ins["X"][0])
    return {}


@register_op("load", no_grad=True, is_host=True)
def load(ctx, ins, attrs):
    return {"Out": [load_tensor_from_file(attrs["file_path"]).to(ctx.device)]}


@register_op("save_combine", no_grad=True, is_host=True)
def save_combine(ctx, ins, attrs):
    """Many tensors into one container file."""
    path = attrs["file_path"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<I", len(ins["X"])))
        for val in ins["X"]:
            _write_tensor(f, val)
    return {}


@register_op("load_combine", no_grad=True, is_host=True)
def load_combine(ctx, ins, attrs):
    with open(attrs["file_path"], "rb") as f:
        (n,) = struct.unpack("<I", f.read(4))
        vals = [_read_tensor(f).to(ctx.device) for _ in range(n)]
    return {"Out": vals}


@register_op("print", no_grad=True, is_host=True)
def print_op(ctx, ins, attrs):
    """print_op.cc analog: the input's shape, dtype and values on the
    host's standard output (a host op: it waits for the device)."""
    msg = attrs.get("message", "")
    for v in ins["In"]:
        arr = torch.as_tensor(v).detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        arr = arr.numpy()
        parts = [msg or "Variable:"]
        if attrs.get("print_tensor_shape", True):
            parts.append(f"shape={list(arr.shape)}")
        if attrs.get("print_tensor_type", True):
            parts.append(f"dtype={arr.dtype}")
        if attrs.get("print_tensor_stats", False) and arr.size:
            parts.append(f"min={arr.min()} max={arr.max()} mean={arr.mean()}")
        print(" ".join(parts))
        if attrs.get("print_tensor_value", True):
            print(arr)
    return {"Out": list(ins["In"])}

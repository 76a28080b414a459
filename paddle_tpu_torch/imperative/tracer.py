"""Eager tensor and autograd for dygraph mode (counterpart of
``paddle_tpu/imperative/tracer.py``).

``VarBase`` mirrors imperative/layer.h:104 (a tensor, its gradient and a
``stop_gradient`` flag); ``Tracer`` mirrors tracer.h:40. Where the JAX
package keeps a tape of ``jax.vjp`` pullbacks, the port lets torch
autograd build the graph: ``trace_op`` runs the registry's emitter with
grad enabled, and ``backward()`` (layer.cc:274 RunBackward) takes the
gradients of every traced ``VarBase`` that is still alive with one
``torch.autograd.grad`` call. The tracer's ``_tape`` keeps one record an
op (its inputs by weak reference) so that backward knows whose
``gradient()`` to fill, and is cleared by backward as the JAX tape is.

Semantics kept from the JAX tape: a backward SETS each ``_grad`` to its
own gradient (torch's ``.grad`` would accumulate); non-leaf ``VarBase``s
on the path get theirs too; ``stop_gradient`` may be set after creation;
outputs in ``info.intermediate_outputs`` and the outputs of ``no_grad``
ops, of eval mode and of an op no input of which needs a gradient are
stop-gradient.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.common import amp_cast, opt
from ..ops.flash_attention import FlashAttention
from ..registry import EmitContext, lookup


def _as_tensor(value, device) -> torch.Tensor:
    """A copy of ``value`` (numpy, a scalar or a tensor) on ``device``
    with no autograd history: the optimizers update parameters in place,
    which must not reach the caller's array. float64 becomes float32, as
    the JAX package's arrays do; integers keep int64 (the port's id
    type)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    a = np.asarray(value)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


class VarBase:
    """Eager tensor with autograd metadata. ``array`` is the tensor;
    assigning a numpy array or a tensor to it makes the ``VarBase`` a
    fresh leaf on the tracer's device."""

    def __init__(self, array, stop_gradient: bool = False, name: str = ""):
        self._stop_gradient = stop_gradient
        self.name = name
        self._grad = None
        self.array = array

    @classmethod
    def _wrap(cls, t: torch.Tensor, stop_gradient: bool, name: str = ""):
        """An op's output: the tensor as it is, autograd history kept."""
        v = cls.__new__(cls)
        v._stop_gradient, v.name, v._grad = stop_gradient, name, None
        v._t = t.detach() if stop_gradient else t
        return v

    @property
    def array(self) -> torch.Tensor:
        return self._t

    @array.setter
    def array(self, value):
        device = (_tracer.device if _tracer is not None
                  else value.device if isinstance(value, torch.Tensor)
                  else torch.device("cpu"))
        self._t = _as_tensor(value, device)
        self._leaf_requires_grad()

    def _leaf_requires_grad(self):
        if self._t.grad_fn is None and self._t.is_floating_point():
            self._t.requires_grad_(not self._stop_gradient)

    @property
    def stop_gradient(self) -> bool:
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        self._stop_gradient = bool(value)
        self._leaf_requires_grad()

    # -- info ----------------------------------------------------------
    @property
    def shape(self):
        return list(self._t.shape)

    @property
    def dtype(self):
        return self._t.dtype

    def numpy(self) -> np.ndarray:
        return self._t.detach().cpu().numpy()

    def gradient(self) -> Optional[np.ndarray]:
        return None if self._grad is None else self._grad.cpu().numpy()

    def clear_gradient(self):
        self._grad = None

    def detach(self) -> "VarBase":
        return VarBase._wrap(self._t.detach(), True, self.name)

    # -- autograd ------------------------------------------------------
    def backward(self):
        _active_tracer().run_backward(self)

    # the reference keeps the `_backward` spelling in v1.2
    _backward = backward

    # -- operator sugar (math_op_patch analog) -------------------------
    def _binary(self, other, op_type, reverse=False):
        if not isinstance(other, VarBase):
            other = VarBase._wrap(torch.as_tensor(
                other, dtype=self._t.dtype, device=self._t.device), True)
        x, y = (other, self) if reverse else (self, other)
        return trace_op(op_type, {"X": [x], "Y": [y]}, {"axis": -1})["Out"][0]

    def __add__(self, o): return self._binary(o, "elementwise_add")
    def __radd__(self, o): return self._binary(o, "elementwise_add", True)
    def __sub__(self, o): return self._binary(o, "elementwise_sub")
    def __rsub__(self, o): return self._binary(o, "elementwise_sub", True)
    def __mul__(self, o): return self._binary(o, "elementwise_mul")
    def __rmul__(self, o): return self._binary(o, "elementwise_mul", True)
    def __truediv__(self, o): return self._binary(o, "elementwise_div")

    def __matmul__(self, o):
        return trace_op("matmul", {"X": [self], "Y": [o]}, {})["Out"][0]

    def __repr__(self):
        return f"VarBase(name={self.name!r}, shape={self.shape})"


class _TapeNode:
    """One recorded op: its type and its inputs, held weakly (a
    ``VarBase`` nobody holds any more has no gradient to be read)."""

    __slots__ = ("op_type", "in_refs")

    def __init__(self, op_type: str, in_vars: List[VarBase]):
        self.op_type = op_type
        self.in_refs = [weakref.ref(v) for v in in_vars]


class Tracer:
    """Owns the tape, the ``torch.Generator`` of the random ops, the
    device and train/eval mode."""

    def __init__(self, seed: int = 0, device=None):
        self.device = torch.device(device or "cpu")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._tape: List[_TapeNode] = []
        self.train_mode = True
        # True inside a recompute() region: ops run but are not recorded
        # (their gradients come from running the whole region again)
        self.paused = False

    def record(self, node: _TapeNode):
        self._tape.append(node)

    def reset(self):
        self._tape.clear()

    def run_backward(self, root: VarBase):
        """Autograd::RunBackward: seed the root's gradient with ones (or
        the ``_grad`` it holds), then set ``_grad`` of every live,
        non-stop-gradient input of a recorded op that the root reaches.
        The graph is freed and the tape cleared."""
        if root._grad is None:
            root._grad = torch.ones_like(root._t).detach()
        if not self._tape or not root._t.requires_grad:
            self._tape.clear()
            return
        targets: Dict[int, List[VarBase]] = {}
        tensors: List[torch.Tensor] = []
        for node in self._tape:
            for ref in node.in_refs:
                v = ref()
                if (v is None or v is root or v.stop_gradient
                        or not v._t.requires_grad):
                    continue
                key = id(v._t)
                if key not in targets:
                    targets[key] = []
                    tensors.append(v._t)
                if all(u is not v for u in targets[key]):
                    targets[key].append(v)
        self._tape.clear()
        if not tensors:
            return
        grads = torch.autograd.grad([root._t], tensors,
                                    grad_outputs=[root._grad],
                                    allow_unused=True)
        for t, g in zip(tensors, grads):
            if g is None:
                continue
            for v in targets[id(t)]:
                v._grad = g


_tracer: Optional[Tracer] = None


def _active_tracer() -> Tracer:
    if _tracer is None:
        raise RuntimeError(
            "imperative mode is not active; wrap code in "
            "paddle_tpu_torch.imperative.guard()")
    return _tracer


def _flash_attention_tape(ctx, ins, attrs):
    """``flash_attention`` on the tape: the forward and backward kernels
    as ``FlashAttention`` (the op's emitter launches the forward alone,
    whose output carries no autograd history on the card). The backward
    reads the forward's saved logsumexp, so a step launches each kernel
    once an attention."""
    q, k, v = amp_cast(ctx, ins["Q"][0], ins["K"][0], ins["V"][0])
    kb = opt(ins, "KeyBias")
    if kb is not None:
        kb = kb.float().contiguous()
    out, _ = FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), kb,
        bool(attrs.get("causal", False)), float(attrs.get("scale", 1.0)))
    return {"Out": [out]}


# ops whose forward emitter autograd cannot differentiate on the card
_TAPE_EMITTERS = {"flash_attention": _flash_attention_tape}


def trace_op(op_type: str, ins: Dict[str, List[VarBase]], attrs=None
             ) -> Dict[str, List[VarBase]]:
    """Run one registered op eagerly on the tracer's device and record
    it. ``ins`` maps slot -> [VarBase]; returns slot -> [VarBase]. The
    eager analog of tracer.cc Trace(op, inputs, outputs), through the
    same emitters the executor runs.

    Inside a recompute region (``tracer.paused``) the op is not recorded
    and runs in the grad mode the region sets: none in its forward, the
    region's own graph in its replay."""
    tracer = _active_tracer()
    info = lookup(op_type)
    attrs = dict(attrs or {})
    flat_vars = [v for vs in ins.values() for v in vs if v is not None]
    wants_grad = (tracer.train_mode and not info.no_grad
                  and any(not v.stop_gradient for v in flat_vars))
    tins = {s: [None if v is None
                else v._t.detach() if v.stop_gradient else v._t
                for v in vs] for s, vs in ins.items()}
    ctx = EmitContext(tracer.device, generator=tracer.generator,
                      is_test=not tracer.train_mode)
    emit = (_TAPE_EMITTERS.get(op_type, info.emitter) if wants_grad
            else info.emitter)
    if tracer.paused:
        outs = emit(ctx, tins, attrs)
    else:
        with torch.set_grad_enabled(wants_grad):
            outs = emit(ctx, tins, attrs)
    result: Dict[str, List[VarBase]] = {}
    for s, ts in outs.items():
        sg = not wants_grad or s in info.intermediate_outputs
        result[s] = [None if t is None else
                     VarBase._wrap(t, sg or t.grad_fn is None
                                   and not t.requires_grad)
                     for t in ts]
    if wants_grad and not tracer.paused:
        tracer.record(_TapeNode(op_type, flat_vars))
    return result

"""Operator registry.

Counterpart of ``paddle_tpu/registry.py``. An OpInfo bundles:

- ``emitter(ctx, ins, attrs) -> outs``: the op's semantics as eager
  PyTorch on tensors. ``ins``/``outs`` map slot name -> list of tensors.
  The executor calls emitters one op at a time; there is no tracing.
- ``grad_maker(op, no_grad_set, grad_sub_block) -> (grad_op_descs,
  grad_to_var)``: the desc-level backward transform ``append_backward``
  calls. Most ops take ``default_vjp_grad_maker``: their grad op
  ``<type>_grad`` re-runs the forward emitter under ``torch.func.vjp``
  (``generic_vjp_grad_emitter``). Ops with a cheaper backward register a
  custom maker and grad emitter (lookup_table, softmax_with_cross_entropy)
  or a custom emitter under the generic op type (flash_attention_grad,
  conv2d_grad, depthwise_conv2d_grad).
- ``infer_shape(op_desc, block)``: compile-time shape/dtype propagation,
  run by ``Block.append_op`` so a built Program is fully typed.

The flags ``no_grad`` and ``intermediate_outputs`` are the JAX package's,
op by op: they decide which grad descs ``append_backward`` writes, so the
programs of the two packages serialize to the same bytes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from .core.desc import OpDesc
from .core.types import GRAD_SUFFIX


class EmitContext:
    """Per-run context handed to emitters: the device every tensor of
    the run lives on, the ``torch.Generator`` random ops draw from (on
    that device), and the bf16 autocast flag."""

    __slots__ = ("generator", "device", "amp", "scope")

    def __init__(self, device: torch.device, generator=None, amp=False,
                 scope=None):
        self.device = device
        self.generator = generator
        self.amp = amp
        self.scope = scope


class OpInfo:
    __slots__ = ("type", "emitter", "grad_maker", "infer_shape", "no_grad",
                 "intermediate_outputs", "needs_rng", "is_host")

    def __init__(self, type: str):
        self.type = type
        self.emitter: Optional[Callable] = None
        self.grad_maker: Optional[Callable] = None
        self.infer_shape: Optional[Callable] = None
        self.no_grad: bool = False
        # output slots that are bookkeeping (saved stats, XShape): they
        # receive no gradient and the grad op reads them as saved values
        self.intermediate_outputs: tuple = ()
        # op draws from the run's generator (*_random)
        self.needs_rng: bool = False
        # op touches the host file system (save/load)
        self.is_host: bool = False


_REGISTRY: Dict[str, OpInfo] = {}


def _get_or_create(op_type: str) -> OpInfo:
    if op_type not in _REGISTRY:
        _REGISTRY[op_type] = OpInfo(op_type)
    return _REGISTRY[op_type]


def lookup(op_type: str) -> OpInfo:
    if op_type not in _REGISTRY:
        raise KeyError(f"operator {op_type!r} is not registered")
    return _REGISTRY[op_type]


def has_op(op_type: str) -> bool:
    return op_type in _REGISTRY


def register_op(op_type: str, *, infer: Optional[Callable] = None,
                no_grad: bool = False, intermediate_outputs: tuple = (),
                grad_maker: Optional[Callable] = None,
                needs_rng: bool = False, is_host: bool = False):
    """Decorator registering ``fn(ctx, ins, attrs) -> outs`` as emitter,
    with ``infer`` as the op's shape/dtype rule ``(op_desc, block)``. An
    op that is not ``no_grad`` and names no ``grad_maker`` gets
    ``default_vjp_grad_maker``."""

    def deco(fn):
        info = _get_or_create(op_type)
        info.emitter = fn
        info.no_grad = no_grad
        info.needs_rng = needs_rng
        info.is_host = is_host
        info.intermediate_outputs = tuple(intermediate_outputs)
        if infer is not None:
            info.infer_shape = infer
        if grad_maker is not None:
            info.grad_maker = grad_maker
        elif not no_grad and info.grad_maker is None:
            info.grad_maker = default_vjp_grad_maker
        return fn

    return deco


def register_grad_maker(op_type: str):
    def deco(fn):
        _get_or_create(op_type).grad_maker = fn
        return fn

    return deco


def register_infer_shape(op_type: str):
    """Attach an infer rule to an op. An op not registered yet gets an
    OpInfo without emitter: programs holding it build and serialize, and
    running it raises until a later slice ports its emitter."""

    def deco(fn):
        _get_or_create(op_type).infer_shape = fn
        return fn

    return deco


# ---------------------------------------------------------------------------
# Generic vjp-based backward
# ---------------------------------------------------------------------------

GENERIC_GRAD_TYPE_SUFFIX = "_grad"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def default_vjp_grad_maker(op: OpDesc, no_grad_set, grad_sub_block=None):
    """The desc of ``<type>_grad``, as the JAX package writes it.

    inputs : every forward input slot (original names), the saved
             intermediate outputs, and ``<slot>@GRAD`` for every other
             forward output
    outputs: ``<slot>@GRAD`` for every forward input ("" where the input
             is in ``no_grad_set``)
    attrs  : the forward attrs + ``__fwd_type__``, the forward emitter to
             differentiate
    """
    info = lookup(op.type)
    inputs: Dict[str, List[str]] = {}
    for slot, names in op.inputs.items():
        inputs[slot] = list(names)
    for slot, names in op.outputs.items():
        if slot in info.intermediate_outputs:
            inputs[slot] = list(names)
            continue
        inputs[slot + GRAD_SUFFIX] = [grad_var_name(n) for n in names]

    outputs: Dict[str, List[str]] = {}
    grad_to_var: Dict[str, str] = {}
    for slot, names in op.inputs.items():
        outs = []
        for n in names:
            g = grad_var_name(n)
            if n in no_grad_set:
                outs.append("")
            else:
                outs.append(g)
                grad_to_var[g] = n
        outputs[slot + GRAD_SUFFIX] = outs

    attrs = dict(op.attrs)
    attrs["__fwd_type__"] = op.type
    grad_op = OpDesc(op.type + GENERIC_GRAD_TYPE_SUFFIX, inputs, outputs, attrs)
    return [grad_op], grad_to_var


def resolve_grad_emitter(op_type: str):
    """Emitter for a grad op: a custom registration wins, else the generic
    vjp."""
    if has_op(op_type) and lookup(op_type).emitter is not None:
        return lookup(op_type).emitter
    if op_type.endswith(GENERIC_GRAD_TYPE_SUFFIX):
        return generic_vjp_grad_emitter
    raise KeyError(f"no emitter for grad op {op_type!r}")


def generic_vjp_grad_emitter(ctx: EmitContext, ins, attrs):
    """Re-run the forward emitter under ``torch.func.vjp`` and apply the
    ``@GRAD`` cotangents (zeros where one is missing, each cast to its
    output's dtype). Input gradients come back in the inputs' dtypes;
    inputs that are not floating point get none.

    ``torch.func.vjp`` is a function transform: it records the forward
    even under the executor's ``torch.no_grad()``. Unlike XLA, eager
    PyTorch does not drop the repeated forward, so each grad op pays its
    op's forward once more."""
    fwd_type = attrs["__fwd_type__"]
    info = lookup(fwd_type)
    fwd_attrs = {k: v for k, v in attrs.items() if k != "__fwd_type__"}
    fwd_in_slots = [s for s in ins
                    if not s.endswith(GRAD_SUFFIX)
                    and s not in info.intermediate_outputs]
    fwd_ins = {s: ins[s] for s in fwd_in_slots}
    # differentiate with respect to the floating-point inputs only
    diff = [(s, j) for s in fwd_in_slots for j, v in enumerate(fwd_ins[s])
            if v is not None and v.is_floating_point()]
    out_index: List[Any] = []

    def fwd(*vals):
        rebuilt = {s: list(fwd_ins[s]) for s in fwd_in_slots}
        for (s, j), v in zip(diff, vals):
            rebuilt[s][j] = v
        outs = info.emitter(ctx, rebuilt, fwd_attrs)
        flat, index = [], []
        for s in sorted(outs):
            if s in info.intermediate_outputs:
                continue
            for j, v in enumerate(outs[s]):
                if v is not None and v.is_floating_point():
                    flat.append(v)
                    index.append((s, j))
        out_index[:] = index
        return tuple(flat)

    primals_out, vjp_fn = torch.func.vjp(
        fwd, *(fwd_ins[s][j] for s, j in diff))
    cotangents = []
    for (s, j), primal in zip(out_index, primals_out):
        gs = ins.get(s + GRAD_SUFFIX)
        if gs is not None and j < len(gs) and gs[j] is not None:
            cotangents.append(gs[j].to(primal.dtype))
        else:
            cotangents.append(torch.zeros_like(primal))
    in_grads = vjp_fn(tuple(cotangents))

    outs: Dict[str, List[Any]] = {s + GRAD_SUFFIX: [None] * len(fwd_ins[s])
                                  for s in fwd_in_slots}
    for (s, j), g in zip(diff, in_grads):
        outs[s + GRAD_SUFFIX][j] = g
    return outs

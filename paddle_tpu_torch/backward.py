"""Declarative autodiff: ``append_backward``.

Counterpart of ``paddle_tpu/backward.py``, with the same bookkeeping, so
the grad descs of the two packages serialize to the same bytes. The
algorithm is the reference's python/paddle/fluid/backward.py (:394
append_backward, :252 _append_backward_ops_, :135
_addup_repetitive_outputs_): walk the op list in reverse from the loss,
ask each op's registered grad maker (registry.py — default: vjp-backed)
for grad OpDescs, insert `sum` ops where a variable's gradient has
multiple contributions, prune branches ending in stop_gradient vars, and
create the grad VarDescs.

Correctness note on summing: grad ops are emitted in reverse topological
order, so every contribution to ``X@GRAD`` (one per forward consumer of
X) is emitted before any grad op that *reads* ``X@GRAD`` (the grad of
X's producer). Contributions are renamed ``X@GRAD@RENAME@i`` and a `sum`
op is inserted right before first use — the sequential-rebinding
executor then sees single-assignment names, i.e. the program is SSA by
construction (the reference needs var-version tracking in
details/var_handle.h for the same reason).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Set

from . import registry
from .core.desc import OpDesc
from .core.types import (GRAD_SUFFIX, OP_ROLE_ATTR_NAME,
                         OP_ROLE_VAR_ATTR_NAME, DataType, OpRole)
from .framework import Block, Variable

_FLOAT_DTYPES = (DataType.FP16, DataType.FP32, DataType.FP64, DataType.BF16)


def _find_op_path(block: Block, target_names: Set[str]) -> List[int]:
    """Indices of ops in block that (transitively) contribute to targets."""
    needed = set(target_names)
    path = []
    for idx in reversed(range(len(block.ops))):
        op = block.ops[idx]
        if set(op.output_arg_names) & needed:
            path.append(idx)
            needed |= set(op.input_arg_names)
    path.reverse()
    return path


def _collect_no_grad(block: Block, user_no_grad: Optional[Set[str]]) -> Set[str]:
    no_grad = set(user_no_grad or ())
    for name, var in block.vars.items():
        if var.desc.stop_gradient:
            no_grad.add(name)
        elif var.desc.dtype is not None and var.desc.dtype not in _FLOAT_DTYPES:
            no_grad.add(name)
    return no_grad


def _make_sum_op(srcs: List[str], dst: str) -> OpDesc:
    return OpDesc("sum", {"X": list(srcs)}, {"Out": [dst]},
                  {OP_ROLE_ATTR_NAME: int(OpRole.BACKWARD)})


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append grad ops for `loss` to its program; returns
    [(param, grad_var)] like the reference (backward.py:394)."""
    program = loss.block.program
    block = program.global_block()
    assert loss.block.idx == 0, "append_backward expects loss in block 0"

    no_grad = _collect_no_grad(block, no_grad_set)

    op_path = _find_op_path(block, {loss.name})
    if not op_path:
        raise ValueError(f"loss {loss.name} is not produced by any op")

    # ---- seed: loss@GRAD = 1 (reference appends fill_constant with
    # op role BACKWARD|LOSS) ----
    loss_grad_name = loss.name + GRAD_SUFFIX
    grad_op_descs: List[OpDesc] = [OpDesc(
        "fill_constant", {}, {"Out": [loss_grad_name]},
        {"shape": list(loss.shape or [1]), "value": 1.0,
         "dtype": loss.desc.dtype,
         OP_ROLE_ATTR_NAME: int(OpRole.BACKWARD) | int(OpRole.LOSS)})]
    grad_to_var: Dict[str, str] = {loss_grad_name: loss.name}

    # ---- reverse walk: per-op grad maker ----
    produced: Dict[str, List[str]] = defaultdict(list)  # base grad -> contributions
    produced[loss_grad_name] = [loss_grad_name]
    rename_count: Dict[str, int] = defaultdict(int)

    for idx in reversed(op_path):
        op = block.ops[idx]
        info = registry.lookup(op.type)
        if info.no_grad or info.grad_maker is None:
            continue
        # skip if none of the op outputs have grads flowing (dead branch)
        has_live_out = any(
            (name + GRAD_SUFFIX) in produced
            for slot, names in op.desc.outputs.items()
            if slot not in info.intermediate_outputs
            for name in names)
        if not has_live_out:
            continue
        # if every input is no_grad, nothing to do
        if all(n in no_grad for n in op.input_arg_names):
            continue

        g_ops, g2v = info.grad_maker(op.desc, no_grad, block)
        for g_op in g_ops:
            # grad makers clone the forward attrs, role included: every
            # grad op gets the BACKWARD role
            role = int(g_op.attrs.get(OP_ROLE_ATTR_NAME, 0) or 0)
            if not (role & int(OpRole.OPTIMIZE)):
                g_op.attrs[OP_ROLE_ATTR_NAME] = (
                    role | int(OpRole.BACKWARD))
            # 1) inputs: materialize sums for multi-contribution grads;
            # zero-fill grads of forward outputs nothing consumed
            # (reference inserts fill_zeros_like, backward.py
            # _append_backward_ops_ / fill_zeros_like_op.cc)
            for in_name in set(g_op.input_arg_names()):
                if not in_name.endswith(GRAD_SUFFIX):
                    continue
                contribs = produced.get(in_name)
                if contribs and (len(contribs) > 1
                                 or contribs[0] != in_name):
                    grad_op_descs.append(_make_sum_op(contribs, in_name))
                    produced[in_name] = [in_name]
                elif not contribs:
                    fwd_name = in_name[:-len(GRAD_SUFFIX)]
                    if block.has_var(fwd_name):
                        grad_op_descs.append(OpDesc(
                            "fill_zeros_like", {"X": [fwd_name]},
                            {"Out": [in_name]},
                            {OP_ROLE_ATTR_NAME: int(OpRole.BACKWARD)}))
                        produced[in_name] = [in_name]
                        grad_to_var.setdefault(in_name, fwd_name)
        # 2) version boundary: this op is the producer of its outputs, so
        # the contributions consumed above belong to the version it wrote;
        # earlier versions of a rebound name (e.g. while's carried vars)
        # accumulate afresh (the reference's var-version tracking,
        # details/var_handle.h, exists for the same reason)
        for out_name in op.output_arg_names:
            produced.pop(out_name + GRAD_SUFFIX, None)
        for g_op in g_ops:
            # 3) outputs: rename duplicate contributions
            for slot, names in g_op.outputs.items():
                for i, g_name in enumerate(names):
                    if not g_name:
                        continue
                    if g_name not in produced or not produced[g_name]:
                        produced[g_name] = [g_name]
                    else:
                        new_name = f"{g_name}@RENAME@{rename_count[g_name]}"
                        rename_count[g_name] += 1
                        names[i] = new_name
                        produced[g_name].append(new_name)
                        if g_name in g2v:
                            g2v[new_name] = g2v[g_name]
            grad_op_descs.append(g_op)
        grad_to_var.update(g2v)

    # ---- final sums for any grads still split (e.g. param grads) ----
    for g_name, contribs in list(produced.items()):
        if len(contribs) > 1:
            grad_op_descs.append(_make_sum_op(contribs, g_name))
            produced[g_name] = [g_name]

    # ---- create grad var descs & append ops to block ----
    with program._backward_role_guard():
        for g_op in grad_op_descs:
            for out_name in g_op.output_arg_names():
                if not out_name or block.has_var(out_name):
                    continue
                base = grad_to_var.get(out_name)
                if base is None and "@RENAME@" in out_name:
                    base = grad_to_var.get(out_name.split("@RENAME@")[0])
                if base is None and out_name.endswith(GRAD_SUFFIX):
                    base = out_name[:-len(GRAD_SUFFIX)]
                fwd = block.vars.get(base) if base else None
                block.create_var(
                    name=out_name,
                    dtype=fwd.desc.dtype if fwd is not None else DataType.FP32,
                    shape=fwd.desc.shape if fwd is not None else None,
                    stop_gradient=True)
            block.append_op(type=g_op.type, inputs=g_op.inputs,
                            outputs=g_op.outputs, attrs=g_op.attrs)

    # ---- collect (param, grad) pairs; stamp op_role_var on producers ----
    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]

    params_and_grads = []
    for p in params:
        g_name = p.name + GRAD_SUFFIX
        if not block.has_var(g_name):
            continue
        g_var = block.var(g_name)
        params_and_grads.append((p, g_var))

    # stamp op_role_var on the final producer of each param grad (what
    # a data-parallel pass keys on for its collectives)
    final_producer = {}
    for op in block.ops:
        for out in op.output_arg_names:
            final_producer[out] = op
    for p, g in params_and_grads:
        op = final_producer.get(g.name)
        if op is not None:
            roles = list(op.attr(OP_ROLE_VAR_ATTR_NAME) or [])
            roles += [p.name, g.name]
            op.set_attr(OP_ROLE_VAR_ATTR_NAME, roles)

    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """The gradient variables of one target with respect to ``inputs``
    (None where the target does not depend on an input), by
    ``append_backward`` on the target's program."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    assert len(targets) == 1, "calc_gradient: single target supported"
    append_backward(targets[0], no_grad_set=no_grad_set)
    block = targets[0].block
    return [block.var(v.name + GRAD_SUFFIX)
            if block.has_var(v.name + GRAD_SUFFIX) else None
            for v in inputs]

"""Control-flow ops (counterpart of ``paddle_tpu/ops/kernels_control.py``):
``increment``, ``while`` and the dense tensor-array ops ``array_write``
and ``array_read``.

``while`` runs its body sub-block (attr ``sub_block``) on the carried
values (``__x_names__``, read from the ``X`` snapshots) until its
condition drops. With a static trip bound (``max_trip_count``, else the
``__inferred_trip_bound__`` the ``While`` layer reads off a counter loop)
it runs exactly ``bound`` trips and freezes every value the body writes
with ``torch.where`` once the condition is false, so no trip reads the
condition on the host and the loop can sit inside a captured CUDA graph;
the results equal the JAX package's ``lax.while_loop`` whenever the true
trip count is within the bound (the JAX ``_while_scan``). Values the body
only reads (the parameters among them) pass through unselected. Without
a bound the condition is read on the host each trip, and the executor
runs the op between device segments, outside any capture
(``executor._is_host``).

``array_write``/``array_read`` take their index as
``lax.dynamic_update_slice`` and ``lax.dynamic_slice`` do (negative from
the end, then clamped into the array), so a masked trip past the end
cannot index out of range on the card.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..core.desc import OpDesc
from ..registry import register_grad_maker, register_op
from .common import same_shape_infer, x


@register_op("increment", no_grad=True, infer=same_shape_infer())
def increment(ctx, ins, attrs):
    """X + step, the step cast to X's dtype as the JAX op casts it (a CPU
    scalar read back as a Python number) and added as a number: no copy
    to the device, so the op can be captured in a CUDA graph."""
    xv = x(ins)
    step = torch.tensor(attrs.get("step", 1.0), dtype=xv.dtype).item()
    return {"Out": [xv + step]}


def trip_bound(attrs) -> int:
    """The while op's static trip bound: ``max_trip_count``, else the
    bound inferred at build time, else 0 (unbounded)."""
    return (int(attrs.get("max_trip_count", 0) or 0)
            or int(attrs.get("__inferred_trip_bound__", 0) or 0))


def _body_writes(body_ops: List[OpDesc]) -> set:
    return {n for op in body_ops for n in op.output_arg_names() if n}


@register_op("while")
def while_op(ctx, ins, attrs):
    """Run the body sub-block over the carried values (module doc)."""
    from ..executor import run_ops

    if ctx.program is None:
        raise ValueError("the while op needs its program's blocks: run it "
                         "through an Executor")
    body = ctx.program.block(attrs["sub_block"]).desc.ops
    names = list(attrs["__x_names__"])
    cond_name = attrs["__cond_name__"]
    vals: Dict[str, torch.Tensor] = dict(zip(names, ins["X"]))
    cond = ins["Condition"][0].reshape(())
    written = [n for n in names if n in _body_writes(body)]
    bound = trip_bound(attrs)

    def trip(cur_cond):
        env = dict(vals)
        env[cond_name] = cur_cond
        run_ops(body, env, ctx)
        return env

    if bound > 0:
        for _ in range(bound):
            env = trip(cond)
            for n in written:
                vals[n] = torch.where(cond, env[n], vals[n])
            cond = cond & env[cond_name].reshape(())
    else:
        while bool(cond):
            env = trip(cond)
            for n in written:
                vals[n] = env[n]
            cond = env[cond_name].reshape(())
    return {"Out": [vals[n] for n in names]}


@register_grad_maker("while")
def _while_grad_maker(op: OpDesc, no_grad_set, grad_sub_block=None):
    """The JAX package differentiates a bounded loop through its masked
    scan and a step-grad sub-block (``while_grad``); the port runs the
    forward only."""
    raise NotImplementedError(
        "backward through a while loop waits for ROADMAP A11 (while_grad)")


def _index(ins, arr) -> torch.Tensor:
    """The array index as ``lax.dynamic_slice`` takes it: a negative one
    counts from the end, then it is clamped into [0, len - 1]."""
    i = ins["I"][0].reshape(()).long()
    n = arr.shape[0]
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


@register_op("array_write", no_grad=True)
def array_write(ctx, ins, attrs):
    """Dense tensor-array write: Out = Array with Array[I] = X."""
    arr = ins["Array"][0]
    idx = _index(ins, arr).reshape(1)
    out = arr.clone()
    out.index_copy_(0, idx, ins["X"][0].to(arr.dtype).unsqueeze(0))
    return {"Out": [out]}


@register_op("array_read", no_grad=True)
def array_read(ctx, ins, attrs):
    """Array[I] of a dense tensor array."""
    arr = ins["Array"][0]
    return {"Out": [torch.index_select(arr, 0, _index(ins, arr).reshape(1))
                    .reshape(arr.shape[1:])]}


# ---------------------------------------------------------------------------
# recurrent (StaticRNN): its desc-level backward only
# ---------------------------------------------------------------------------

@register_grad_maker("recurrent")
def recurrent_grad_maker(op: OpDesc, no_grad_set, grad_sub_block=None):
    """The JAX package's maker: the default vjp desc, plus a step-grad
    sub-block (the step ops reversed through their own grad makers) and
    its seeds and reads in the attrs, so that a program with a StaticRNN
    appends the same backward, byte for byte. The ``recurrent`` op itself
    has no emitter yet (ROADMAP A11)."""
    from ..core.types import GRAD_SUFFIX
    from ..registry import default_vjp_grad_maker

    g_ops, g2v = default_vjp_grad_maker(op, no_grad_set)
    if grad_sub_block is None or not g_ops:
        return g_ops, g2v
    gop = g_ops[0]
    program = grad_sub_block.program
    sub = program.block(op.attrs["sub_block"])
    seeds = ([n + GRAD_SUFFIX for n in op.attrs["__out_names__"]]
             + [n + GRAD_SUFFIX for n in op.attrs["__state_post__"]])
    reads = ([n + GRAD_SUFFIX for n in op.attrs["__seq_names__"]]
             + [n + GRAD_SUFFIX for n in op.attrs["__state_pre__"]]
             + [n + GRAD_SUFFIX for n in op.attrs["__param_names__"]])
    gblk_idx, reads_mask = _build_step_grad_block(program, sub, seeds, reads,
                                                  no_grad_set)
    gop.attrs["__grad_sub_block__"] = gblk_idx
    gop.attrs["__grad_reads__"] = reads_mask
    return g_ops, g2v


def _build_step_grad_block(program, sub, seeds, reads, no_grad_set):
    """Reverse-walk ``sub``'s ops through each op's grad maker into a new
    sub-block of ``program``, with append_backward's bookkeeping at step
    scope (sums of several contributions, zero fills, ``@RENAME@``
    versions). ``seeds`` are the grads set before the block runs, ``reads``
    the grads read after it. Returns (block index, reads with "" where no
    grad flows)."""
    from collections import defaultdict

    from .. import registry as _reg
    from ..backward import _make_sum_op
    from ..core.types import GRAD_SUFFIX

    produced = defaultdict(list)
    for s in seeds:
        produced[s] = [s]
    rename_count = defaultdict(int)
    grad_ops = []
    for sop in reversed(sub.desc.ops):
        info = _reg.lookup(sop.type)
        if info.no_grad or info.grad_maker is None:
            continue
        live = any((n + GRAD_SUFFIX) in produced
                   for slot, names in sop.outputs.items()
                   if slot not in info.intermediate_outputs
                   for n in names)
        if not live:
            continue
        step_g_ops, _g2v = info.grad_maker(sop, set(no_grad_set), sub)
        for g in step_g_ops:
            for in_name in set(g.input_arg_names()):
                if not in_name.endswith(GRAD_SUFFIX):
                    continue
                contribs = produced.get(in_name)
                if contribs and (len(contribs) > 1
                                 or contribs[0] != in_name):
                    grad_ops.append(_make_sum_op(contribs, in_name))
                    produced[in_name] = [in_name]
                elif not contribs:
                    fwd = in_name[:-len(GRAD_SUFFIX)]
                    grad_ops.append(OpDesc(
                        "fill_zeros_like", {"X": [fwd]},
                        {"Out": [in_name]}, {}))
                    produced[in_name] = [in_name]
        for out_name in sop.output_arg_names():
            produced.pop(out_name + GRAD_SUFFIX, None)
        for g in step_g_ops:
            for slot, names in g.outputs.items():
                for i, g_name in enumerate(names):
                    if not g_name:
                        continue
                    if g_name not in produced or not produced[g_name]:
                        produced[g_name] = [g_name]
                    else:
                        new_name = (f"{g_name}@RENAME@"
                                    f"{rename_count[g_name]}")
                        rename_count[g_name] += 1
                        names[i] = new_name
                        produced[g_name].append(new_name)
            grad_ops.append(g)
    for name in reads:
        contribs = produced.get(name)
        if contribs and (len(contribs) > 1 or contribs[0] != name):
            grad_ops.append(_make_sum_op(contribs, name))
            produced[name] = [name]
    gblk = program._create_block(parent_idx=sub.idx)
    program._rollback()
    for g in grad_ops:
        gblk.desc.ops.append(g)
    return gblk.idx, [n if produced.get(n) else "" for n in reads]

"""Control-flow ops (counterpart of ``paddle_tpu/ops/kernels_control.py``):
``increment``, ``while`` and its backward ``while_grad``, ``recurrent``
(StaticRNN, DynamicRNN) and the dense tensor-array ops ``array_write``
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
(``executor._is_host``). ``while_grad`` runs the bounded loop again
under ``torch.func.vjp`` with respect to the floating-point carried
values; a loop without a bound has no backward, and ``append_backward``
says so.

``recurrent`` runs its step sub-block once per time step of a static T
(``X[0].shape[1]``), in a Python loop: sequence inputs [B, T, ...] give
the step their slice at t, the states are carried from ``__state_pre__``
to ``__state_post__``, and the step outputs stack back to [B, T, ...].
With a ``Length`` input a row's state freezes and its outputs are zero
from its length on (``torch.where`` on a tensor compare, so the loop can
be captured). Its backward is the generic vjp of the whole loop.

``array_write``/``array_read`` take their index as
``lax.dynamic_update_slice`` and ``lax.dynamic_slice`` do (negative from
the end, then clamped into the array), so a masked trip past the end
cannot index out of range on the card.

Conditional control flow computes every branch and selects, so nothing
reads a condition on the host and the step can be captured:
``conditional_block`` runs its sub-block and keeps each output's prior
value where ``Cond`` is false (``lax.cond``'s result for a sub-block with
no side effects); ``if_else`` merges IfElse's two dense branches row by
row; ``switch_merge`` takes Switch's first true case. The LoD tensor-array
ops (``write_to_array``, ``read_from_array``, ``lod_array_length``,
``tensor_array_to_tensor``) are host ops over a Python list of tensors:
they split the captured segments, as ``chunk_eval`` does. The dense LoD
compat ops (``max_sequence_len``, ``lod_tensor_to_array``,
``array_to_lod_tensor``, ``shrink_rnn_memory``, ``split_lod_tensor``,
``merge_lod_tensor``) run on the device.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..core.desc import OpDesc
from ..registry import register_grad_maker, register_op
from .common import opt, same_shape_infer, scalar_infer, set_out_var, x


@register_op("increment", no_grad=True, infer=same_shape_infer())
def increment(ctx, ins, attrs):
    """X + step, the step cast to X's dtype as the JAX op casts it (a CPU
    scalar read back as a Python number) and added as a number: no copy
    to the device, so the op can be captured in a CUDA graph."""
    xv = x(ins)
    step = torch.tensor(attrs.get("step", 1.0), dtype=xv.dtype).item()
    return {"Out": [xv + step]}


def trip_bound(attrs) -> int:
    """The while op's static trip bound (the JAX ``_resolve_trip_bound``):
    ``max_trip_count``, else the bound inferred at build time, else 0
    (unbounded, not differentiable)."""
    return (int(attrs.get("max_trip_count", 0) or 0)
            or int(attrs.get("__inferred_trip_bound__", 0) or 0))


_UNBOUNDED_WHILE_GRAD_MSG = (
    "backward through `while` requires a static trip bound: none was "
    "given and the loop did not match the bounded-counter pattern "
    "(cond = less_than(i, n) with constant start/limit and a single "
    "positive-step increment of i before the comparison in the body) "
    "from which one is inferred. Fix: build the loop with "
    "fluid.layers.While(cond, max_trip_count=N), N an upper bound on "
    "the trip count (an overestimate is safe — iterations past the "
    "condition are masked out; lax.while_loop itself is not "
    "reverse-differentiable).")


def _body_writes(body_ops: List[OpDesc]) -> set:
    return {n for op in body_ops for n in op.output_arg_names() if n}


def _program(ctx, op_type):
    if ctx.program is None:
        raise ValueError(f"the {op_type} op needs its program's blocks: "
                         "run it through an Executor")
    return ctx.program


def _while_loop(ctx, attrs, xs, cond, bound):
    """The while body over the carried values ``xs`` (in
    ``__x_names__`` order) from the condition ``cond``: ``bound`` masked
    trips when ``bound`` > 0, else trips until the condition, read on the
    host, drops. Returns the final carried values."""
    from ..executor import run_ops

    body = _program(ctx, "while").block(attrs["sub_block"]).desc.ops
    names = list(attrs["__x_names__"])
    cond_name = attrs["__cond_name__"]
    vals: Dict[str, torch.Tensor] = dict(zip(names, xs))
    cond = cond.reshape(())
    written = [n for n in names if n in _body_writes(body)]

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
    return [vals[n] for n in names]


@register_op("while")
def while_op(ctx, ins, attrs):
    """Run the body sub-block over the carried values (module doc)."""
    return {"Out": _while_loop(ctx, attrs, list(ins["X"]),
                               ins["Condition"][0], trip_bound(attrs))}


@register_op("while_grad", no_grad=True)
def while_grad(ctx, ins, attrs):
    """Backward of the bounded while: the masked loop run again under
    ``torch.func.vjp``, differentiating only the floating-point carried
    values (counters and predicates are constants of the vjp); a missing
    cotangent is zeros. As in the generic vjp, the forward runs twice."""
    bound = trip_bound(attrs)
    if bound <= 0:
        raise ValueError(_UNBOUNDED_WHILE_GRAD_MSG)
    xs = list(ins["X"])
    cond0 = ins["Condition"][0]
    diff = [i for i, v in enumerate(xs)
            if v is not None and v.is_floating_point()]

    def fwd(*diff_vals):
        vals = list(xs)
        for i, v in zip(diff, diff_vals):
            vals[i] = v
        finals = _while_loop(ctx, attrs, vals, cond0, bound)
        return tuple(finals[i] for i in diff)

    primals, vjp_fn = torch.func.vjp(fwd, *(xs[i] for i in diff))
    out_grads = ins.get("Out@GRAD", [])
    cots = []
    for i, p in zip(diff, primals):
        g = out_grads[i] if i < len(out_grads) else None
        cots.append(g.to(p.dtype) if g is not None else torch.zeros_like(p))
    grads = vjp_fn(tuple(cots))
    out = [None] * len(xs)
    for i, g in zip(diff, grads):
        out[i] = g
    return {"X@GRAD": out}


@register_grad_maker("while")
def while_grad_maker(op: OpDesc, no_grad_set, grad_sub_block=None):
    """The JAX package's maker: X, Condition, Out@GRAD -> X@GRAD ("" for
    carried values in ``no_grad_set``). It raises here, at
    ``append_backward`` time, when the loop has no static trip bound. With
    ``grad_sub_block`` it attaches the body SSA-renamed
    (``__ssa_sub_block__``, ``__ssa_init__``/``__ssa_final__``/
    ``__ssa_cond_final__``) and the step-grad block walked from it
    (``__grad_sub_block__``, ``__grad_reads__``), so that a train program
    holding a While is byte-identical to the JAX package's; the port's
    ``while_grad`` does not read them."""
    if trip_bound(op.attrs) <= 0:
        raise ValueError(_UNBOUNDED_WHILE_GRAD_MSG)
    from ..core.types import GRAD_SUFFIX

    inputs = {"X": list(op.inputs["X"]),
              "Condition": list(op.inputs["Condition"]),
              "Out@GRAD": [n + GRAD_SUFFIX for n in op.outputs["Out"]]}
    grad_to_var = {}
    outs = []
    for n in op.inputs["X"]:
        if n in no_grad_set:
            outs.append("")
        else:
            outs.append(n + GRAD_SUFFIX)
            grad_to_var[n + GRAD_SUFFIX] = n
    gop = OpDesc("while_grad", inputs, {"X@GRAD": outs}, dict(op.attrs))
    if grad_sub_block is not None:
        program = grad_sub_block.program
        sub = program.block(op.attrs["sub_block"])
        carried = list(op.attrs["__x_names__"])
        ssa_idx, init_names, final_names = _ssa_body(
            program, sub, carried + [op.attrs["__cond_name__"]])
        seeds = [final_names[n] + GRAD_SUFFIX for n in carried]
        reads = [init_names[n] + GRAD_SUFFIX for n in carried]
        gidx, reads_mask = _build_step_grad_block(
            program, program.block(ssa_idx), seeds, reads, no_grad_set)
        gop.attrs["__ssa_sub_block__"] = ssa_idx
        gop.attrs["__ssa_init__"] = [init_names[n] for n in carried]
        gop.attrs["__ssa_final__"] = [final_names[n] for n in carried]
        gop.attrs["__ssa_cond_final__"] = final_names[
            op.attrs["__cond_name__"]]
        gop.attrs["__grad_sub_block__"] = gidx
        gop.attrs["__grad_reads__"] = reads_mask
    return [gop], grad_to_var


def _ssa_body(program, sub, tracked):
    """Copy ``sub``'s ops into a new sub-block with in-place rebinds
    SSA-renamed: each write to a name already bound (or tracked) makes a
    fresh ``name@V{k}``, and reads take the current version. Returns
    (block index, init, final): each tracked name's first and last SSA
    name (init is the plain name: a body reads its carried state before
    rebinding it)."""
    cur = {}
    counter = {}

    def read_name(n):
        return cur.get(n, n)

    def write_name(n):
        if n in cur or n in tracked:
            k = counter.get(n, 0)
            counter[n] = k + 1
            v = f"{n}@V{k}"
        else:
            v = n
        cur[n] = v
        return v

    blk = program._create_block(parent_idx=sub.idx)
    program._rollback()
    for sop in sub.desc.ops:
        ins = {slot: [read_name(n) for n in names]
               for slot, names in sop.inputs.items()}
        outs = {slot: [write_name(n) for n in names]
                for slot, names in sop.outputs.items()}
        blk.desc.ops.append(OpDesc(sop.type, ins, outs, dict(sop.attrs)))
    init = {n: n for n in tracked}
    final = {n: cur.get(n, n) for n in tracked}
    return blk.idx, init, final


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
# recurrent (StaticRNN, DynamicRNN)
# ---------------------------------------------------------------------------

@register_grad_maker("recurrent")
def recurrent_grad_maker(op: OpDesc, no_grad_set, grad_sub_block=None):
    """The JAX package's maker: the default vjp desc (its emitter, the
    generic vjp, runs the whole loop again under ``torch.func.vjp``),
    plus a step-grad sub-block (the step ops reversed through their own
    grad makers) and its seeds and reads in the attrs, so that a program
    with a StaticRNN appends the same backward, byte for byte. The port
    does not read the step-grad block."""
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


@register_op("recurrent")
def recurrent(ctx, ins, attrs):
    """The step sub-block over T = ``X[0].shape[1]`` steps (module doc),
    in reverse with ``is_reverse``. The step reads the outer values it
    uses (the weights) from ``Params`` (``__param_names__``), so their
    gradients flow through the vjp. Outputs ``Out`` [B, T, ...] per step
    output and ``HFinal`` per state."""
    from ..executor import run_ops

    body = _program(ctx, "recurrent").block(attrs["sub_block"]).desc.ops
    seq_names = attrs["__seq_names__"]
    pre_names = attrs["__state_pre__"]
    post_names = attrs["__state_post__"]
    out_names = attrs["__out_names__"]
    seqs = ins["X"]
    state = list(ins["H0"])
    params = dict(zip(attrs["__param_names__"], ins.get("Params", [])))
    length = opt(ins, "Length")
    if length is not None:
        length = length.reshape(-1)
    t_len = seqs[0].shape[1]
    steps = range(t_len)
    if attrs.get("is_reverse", False):
        steps = reversed(steps)

    def live_rows(live, v):
        return live.reshape((-1,) + (1,) * (v.dim() - 1))

    outs = [[None] * t_len for _ in out_names]
    for t in steps:
        env = dict(params)
        env.update((n, s[:, t]) for n, s in zip(seq_names, seqs))
        env.update(zip(pre_names, state))
        run_ops(body, env, ctx)
        live = None if length is None else t < length
        new_state = [env[n] for n in post_names]
        if live is not None:
            new_state = [torch.where(live_rows(live, nv), nv, old)
                         for nv, old in zip(new_state, state)]
        state = new_state
        for k, n in enumerate(out_names):
            ov = env[n]
            if live is not None:
                ov = torch.where(live_rows(live, ov), ov, 0)
            outs[k][t] = ov
    return {"Out": [torch.stack(o, dim=1) for o in outs], "HFinal": state}


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


# ---------------------------------------------------------------------------
# conditional control flow: conditional_block, IfElse, Switch
# ---------------------------------------------------------------------------

@register_op("conditional_block", no_grad=True)
def conditional_block(ctx, ins, attrs):
    """The sub-block (attr ``sub_block``) run on ``Input``
    (``__in_names__``) and the prior outputs, then each output
    (``__out_names__``) taken from the sub-block where ``Cond`` holds and
    kept at its ``PriorOut`` value where it does not. No host read of
    ``Cond``: this is ``lax.cond``'s result for a sub-block without side
    effects."""
    from ..executor import run_ops

    body = _program(ctx, "conditional_block").block(
        attrs["sub_block"]).desc.ops
    out_names = list(attrs["__out_names__"])
    cond = ins["Cond"][0].reshape(())
    prior = list(ins.get("PriorOut", []))
    env = dict(zip(attrs["__in_names__"], ins.get("Input", [])))
    for n, v in zip(out_names, prior):
        env.setdefault(n, v)
    run_ops(body, env, ctx)
    return {"Out": [torch.where(cond, env[n], p)
                    for n, p in zip(out_names, prior)]}


def _if_else_infer(op: OpDesc, block):
    for t_name, o_name in zip(op.input("TrueOut"), op.output("Out")):
        d = block._find_var_desc_recursive(t_name)
        if d is not None:
            set_out_var(block, o_name, d.shape, d.dtype)


@register_op("if_else", infer=_if_else_infer)
def if_else(ctx, ins, attrs):
    """IfElse's merge: each row from TrueOut where the [N, 1] ``Cond``
    holds, else from FalseOut. Both branches ran over the whole batch; the
    generic vjp routes each row's gradient to the branch that made it."""
    cond = ins["Cond"][0]
    outs = []
    for t, f in zip(ins["TrueOut"], ins["FalseOut"]):
        if t.dtype != f.dtype:
            raise TypeError(f"if_else branch outputs must share a dtype, "
                            f"got {t.dtype} vs {f.dtype}")
        c = cond.reshape((cond.shape[0],) + (1,) * (t.dim() - 1))
        outs.append(torch.where(c, t, f))
    return {"Out": outs}


@register_op("switch_merge", infer=same_shape_infer(in_slot="Default"))
def switch_merge(ctx, ins, attrs):
    """Switch's merge: the value of the FIRST case whose condition holds,
    else ``Default``, as a where chain built from the last case back. A
    condition of one element selects as a 0-d tensor, on the device."""
    out = ins["Default"][0]
    for c, v in zip(reversed(ins.get("Conds", [])),
                    reversed(ins.get("X", []))):
        cond = c.reshape(()) if c.numel() == 1 else c
        out = torch.where(cond, v, out)
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# LoD tensor arrays: host ops over a Python list of tensors
# ---------------------------------------------------------------------------

def _host_index(i) -> int:
    return int(i.reshape(-1)[0])


@register_op("write_to_array", no_grad=True, is_host=True)
def write_to_array(ctx, ins, attrs):
    """Out = Array (a new list, the empty list without one) with X at
    I, grown with None as needed."""
    arr = opt(ins, "Array")
    arr = list(arr) if isinstance(arr, (list, tuple)) else []
    i = _host_index(ins["I"][0])
    while len(arr) <= i:
        arr.append(None)
    arr[i] = ins["X"][0]
    return {"Out": [arr]}


@register_op("read_from_array", no_grad=True, is_host=True)
def read_from_array(ctx, ins, attrs):
    arr = ins["X"][0]
    i = _host_index(ins["I"][0])
    n = len(arr) if isinstance(arr, (list, tuple)) else 0
    if i >= n:
        raise IndexError(f"read_from_array: index {i} out of range ({n})")
    return {"Out": [arr[i]]}


@register_op("lod_array_length", no_grad=True, is_host=True,
             infer=scalar_infer(dtype="int64", shape=(1,)))
def lod_array_length(ctx, ins, attrs):
    arr = ins["X"][0]
    n = len(arr) if isinstance(arr, (list, tuple)) else 0
    return {"Out": [torch.tensor([n], dtype=torch.long, device=ctx.device)]}


def _array_items(arr):
    """The tensors of a list array (its unwritten slots skipped), or the
    rows of a dense [max_len, ...] array."""
    if isinstance(arr, torch.Tensor):
        return list(arr.unbind(0))
    return [a for a in arr if a is not None]


@register_op("tensor_array_to_tensor", no_grad=True, is_host=True)
def tensor_array_to_tensor(ctx, ins, attrs):
    """The array's tensors concatenated (or stacked, ``use_stack``) along
    ``axis`` on the device; OutIndex their extents along it."""
    vals = _array_items(ins["X"][0])
    axis = int(attrs.get("axis", 0))
    sizes = [v.shape[axis] for v in vals]
    out = (torch.stack if attrs.get("use_stack", False) else torch.cat)(
        vals, dim=axis)
    return {"Out": [out], "OutIndex": [torch.tensor(
        sizes, dtype=torch.long, device=out.device)]}


# ---------------------------------------------------------------------------
# the dense LoD compat ops of Fluid's DynamicRNN and IfElse machinery: the
# "array" is the time-major [T, B, ...] view, shrinking is masking
# ---------------------------------------------------------------------------

@register_op("max_sequence_len", no_grad=True,
             infer=scalar_infer(dtype="int64", shape=(1,)))
def max_sequence_len(ctx, ins, attrs):
    """The longest length of the RankTable input (the Length vector)."""
    return {"Out": [ins["RankTable"][0].reshape(-1).max().reshape(1).long()]}


@register_op("lod_tensor_to_array")
def lod_tensor_to_array(ctx, ins, attrs):
    """Padded [B, T, ...] -> time-major [T, B, ...]. No length sort (the
    caller reorders with reorder_lod_tensor_by_rank)."""
    return {"Out": [ins["X"][0].transpose(0, 1).contiguous()]}


@register_op("array_to_lod_tensor")
def array_to_lod_tensor(ctx, ins, attrs):
    """The inverse of lod_tensor_to_array."""
    return {"Out": [ins["X"][0].transpose(0, 1).contiguous()]}


@register_op("shrink_rnn_memory")
def shrink_rnn_memory(ctx, ins, attrs):
    """At step I the rows whose length is at most I are zeroed (Fluid
    drops them; the batch keeps its shape here)."""
    xv = ins["X"][0]
    length = ins["RankTable"][0].reshape(-1)
    i = ins["I"][0].reshape(-1)[0].to(torch.int32)
    alive = (length > i).reshape((-1,) + (1,) * (xv.dim() - 1))
    return {"Out": [xv * alive.to(xv.dtype)]}


def _row_mask(mask, like):
    return mask.reshape(-1).to(torch.bool).reshape(
        (-1,) + (1,) * (like.dim() - 1))


@register_op("split_lod_tensor", no_grad=True)
def split_lod_tensor(ctx, ins, attrs):
    """IfElse's row router: rows where Mask holds -> OutTrue, the others ->
    OutFalse, both of the full shape with the other rows zeroed."""
    xv = ins["X"][0]
    m = _row_mask(ins["Mask"][0], xv)
    zero = torch.zeros_like(xv)
    return {"OutTrue": [torch.where(m, xv, zero)],
            "OutFalse": [torch.where(m, zero, xv)]}


@register_op("merge_lod_tensor")
def merge_lod_tensor(ctx, ins, attrs):
    """The row-wise inverse of split_lod_tensor."""
    t = ins["InTrue"][0]
    m = _row_mask(ins["Mask"][0], t)
    return {"Out": [torch.where(m, t, ins["InFalse"][0])]}

"""The BuildStrategy pass pipeline (counterpart of
``paddle_tpu/ir/pipeline.py``; reference build_strategy.h knobs).

The executor runs it on the live op list of a ``CompiledProgram`` run
(memoized per program version, fetch names and flags) when the
corresponding BuildStrategy flags are set:

- ``fuse_attention_ops``       -> the unfused matmul -> mask -> softmax ->
                                  matmul chain, forward and backward,
                                  becomes ``flash_attention`` and
                                  ``flash_attention_grad`` (the hand
                                  CUDA kernels on the card)
- ``memory_optimize``          -> constant folding (attr-rooted const
                                  chains collapse into literal
                                  ``pt_const`` ops) + common-subexpression
                                  elimination + dead-op elimination
- ``fuse_elewise_add_act_ops`` -> the fuse_elewise_add_act_pass.cc
                                  pattern over forward+backward op lists
- ``fuse_all_optimizer_ops``   -> per-parameter adam ops group by
                                  (dtype, hyperparameters) into one
                                  ``fused_adam`` each (optimizer.py
                                  declares the slots, ops/kernels_optim.py
                                  owns the emitter); bitwise equal
- ``fuse_conv_ops``            -> inference conv [+ bias] + batch_norm
                                  [+ act] and training conv + bias + act
                                  (forward and backward) become one
                                  ``fused_conv2d`` each
- ``FLAGS.conv_layout_nhwc``   -> the conv/pool/batch_norm spine, forward
                                  and backward, runs NHWC between one
                                  transpose in and one out (off by
                                  default in the port, see
                                  ``effective_flags``)

Contract: every pass preserves bit-exact fetches and scope state, except
the attention fusion, which is bit-close (it reassociates the scale). The
pipeline NEVER mutates the caller's OpDescs (rewrites build fresh descs),
never reorders reads across writes, never removes or deduplicates
RNG-consuming ops, and leaves host ops alone.

Every rewrite gives the op list the JAX package's pipeline gives for the
same program: op types, slots, variable names and attrs.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import registry
from ..core.desc import OpDesc
from ..core.types import (GRAD_SUFFIX, OP_ROLE_ATTR_NAME,
                          OP_ROLE_VAR_ATTR_NAME, OpRole)
from ..ops.common import set_out_var
from . import analyze

__all__ = ["fingerprint", "effective_flags", "run_pipeline",
           "constant_fold_ops", "cse_ops", "dead_op_elimination",
           "fuse_elewise_add_act_ops", "fuse_optimizer_ops",
           "fuse_attention_chain_ops", "fuse_conv_bn_ops",
           "fuse_conv_epilogue_ops", "conv_layout_nhwc_ops",
           "block_var_dtype"]

# attrs that carry program structure (sub-blocks): ops holding them are
# control flow and must never be folded/merged/moved
_CONTROL_ATTRS = ("sub_block", "block", "sub_block_idx")

# attrs that are bookkeeping, not semantics: excluded from CSE equality
_META_ATTRS = (OP_ROLE_ATTR_NAME, OP_ROLE_VAR_ATTR_NAME, "op_namescope",
               "op_callstack")

# constant-source ops: outputs derive from attrs alone (no inputs)
_CONST_SRC = ("fill_constant", "assign_value")

# pure elementwise/shape ops the folder may evaluate eagerly
_FOLDABLE = frozenset((
    "scale", "cast", "sqrt", "square", "relu", "tanh", "sigmoid", "exp",
    "log", "abs", "sign", "floor", "ceil", "clip", "pow",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_pow", "elementwise_max",
    "elementwise_min", "reshape", "reshape2", "transpose", "transpose2",
    "concat", "expand", "squeeze", "squeeze2", "unsqueeze", "unsqueeze2",
))

# folded literals above this size stay ops (a baked [B, L, L] mask costs
# more to hold than the one fill it replaces)
_FOLD_MAX_ELEMS = 65536

# grad op types the port registers only to give the generic vjp type a
# custom emitter; the JAX package does not register them, so its passes
# treat them as opaque (never merged, never dropped), and so do these
_OPAQUE_GRAD_TYPES = ("flash_attention_grad", "conv2d_grad",
                      "depthwise_conv2d_grad")


def fingerprint(build_strategy) -> Tuple[str, ...]:
    """Stable pipeline id for a BuildStrategy: which pass groups run.
    Part of the executor's memo key of rewritten op lists."""
    if build_strategy is None:
        return ()
    fp = []
    if getattr(build_strategy, "fuse_conv_ops", False):
        fp.append("convfuse")
    if getattr(build_strategy, "fuse_attention_ops", False):
        fp.append("attnfuse")
    if getattr(build_strategy, "memory_optimize", False):
        fp.append("slim")
    if getattr(build_strategy, "fuse_elewise_add_act_ops", False):
        fp.append("elewise")
    if getattr(build_strategy, "fuse_all_optimizer_ops", False):
        fp.append("optfuse")
    return tuple(fp)


def effective_flags(flags: Sequence[str], device_type: str
                    ) -> Tuple[str, ...]:
    """Map a fingerprint() tuple to the pass groups that run on
    ``device_type`` (``torch.device.type``).

    ``optfuse`` is skipped on the CPU unless
    ``FLAGS.fuse_optimizer_ops_on_cpu``, as in the JAX package (which
    measured the concat -> update -> split rewrite slower on XLA:CPU), so
    that a CPU run compares per-parameter updates with per-parameter
    updates.

    ``nhwc`` (conv_layout_nhwc_ops) is appended only when
    ``FLAGS.conv_layout_nhwc`` is set. The JAX package sets it by
    default, on a TPU measurement (its conv tilings prefer channels
    last); the port keeps NCHW until the card's own numbers decide
    (chip_smoke.py phase 9 times both layouts)."""
    from ..utils.flags import FLAGS
    out = list(flags)
    if (device_type == "cpu" and "optfuse" in out
            and not FLAGS.fuse_optimizer_ops_on_cpu):
        out.remove("optfuse")
    if FLAGS.conv_layout_nhwc and "nhwc" not in out:
        out.append("nhwc")
    return tuple(out)


def _pt_const_infer(op, block):
    v = np.asarray(op.attrs.get("value"))
    for n in op.output("Out"):
        set_out_var(block, n, list(v.shape), str(v.dtype))


@registry.register_op("pt_const", no_grad=True, infer=_pt_const_infer)
def _pt_const(ctx, ins, attrs):
    """Literal produced by constant folding: the folded numpy value rides
    in the op's attrs (in memory only: rewritten op lists are never
    serialized)."""
    return {"Out": [torch.as_tensor(attrs["value"], device=ctx.device)]}


# ---------------------------------------------------------------------------
# shared analysis
# ---------------------------------------------------------------------------

def _needs_rng(op: OpDesc) -> bool:
    return bool(registry.has_op(op.type)
                and registry.lookup(op.type).needs_rng)


def _deterministic(op: OpDesc) -> bool:
    """True when re-emitting this op with the same inputs yields the
    same value (CSE-able / foldable candidate)."""
    if op.type in ("feed", "fetch") or op.type in _OPAQUE_GRAD_TYPES:
        return False
    if any(a in op.attrs for a in _CONTROL_ATTRS):
        return False
    if registry.has_op(op.type):
        info = registry.lookup(op.type)
        return not (info.is_host or info.needs_rng)
    return False


def _canon_attrs(attrs: Dict[str, Any], skip=_META_ATTRS):
    """Hashable canonical view of an attrs dict (lists -> tuples,
    arrays -> bytes), with bookkeeping attrs dropped."""
    def conv(v):
        if isinstance(v, (list, tuple)):
            return tuple(conv(x) for x in v)
        if isinstance(v, np.ndarray):
            return (str(v.dtype), v.shape, v.tobytes())
        if isinstance(v, dict):
            return tuple(sorted((k, conv(x)) for k, x in v.items()))
        return v
    try:
        return tuple(sorted((k, conv(v)) for k, v in attrs.items()
                            if k not in skip))
    except TypeError:
        return ("<unhashable>", id(attrs))


def _clone_with_renamed_inputs(op: OpDesc, rename: Dict[str, str]) -> OpDesc:
    """Copy-on-write rename: the pipeline never mutates the descs the
    program block owns."""
    if not rename or not any(n in rename for n in op.input_arg_names()):
        return op
    return OpDesc(op.type,
                  {s: [rename.get(n, n) for n in names]
                   for s, names in op.inputs.items()},
                  {s: list(names) for s, names in op.outputs.items()},
                  dict(op.attrs))


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

class _FoldAbort(Exception):
    """A const chain evaluated past the size cap (or failed)."""


def constant_fold_ops(ops: List[OpDesc], needed: Set[str]
                      ) -> Tuple[List[OpDesc], int]:
    """Fold ops computable from attr-rooted constant chains
    (fill_constant/assign_value sources) into ``pt_const`` literals,
    evaluated eagerly through the port's emitters on the CPU and stored
    as numpy values in the attrs.

    Evaluation is lazy: a const-source op's value is only materialized
    when a foldable consumer requests it, so a program full of
    fill_constants with no foldable consumers (the common training
    case) costs the pass nothing.

    Scope-persistable vars are not constants: their values are runtime
    state (a host-side schedule may change them between runs)."""
    writers = analyze.writer_counts(ops)
    producer: Dict[str, OpDesc] = {}  # const-expr var -> producing op
    const_vals: Dict[str, np.ndarray] = {}
    # aborts memoize like successes: an over-cap (or failing) producer
    # with several foldable consumers is evaluated once
    aborted: Set[str] = set()
    ctx = registry.EmitContext(torch.device("cpu"))

    def evaluate(op: OpDesc) -> Dict[str, np.ndarray]:
        """Evaluate one const-expr op (inputs on demand, memoized)."""
        try:
            ins = {}
            for slot, names in op.inputs.items():
                vals = []
                for n in names:
                    if not n:
                        vals.append(None)
                        continue
                    if n in aborted:
                        raise _FoldAbort(n)
                    if n not in const_vals:
                        const_vals.update(evaluate(producer[n]))
                    vals.append(torch.from_numpy(const_vals[n]))
                ins[slot] = vals
            result = registry.lookup(op.type).emitter(ctx, ins, op.attrs)
            out: Dict[str, np.ndarray] = {}
            for slot, names in op.outputs.items():
                for n, v in zip(names, (result or {}).get(slot, [])):
                    if not n:
                        continue
                    if v.numel() > _FOLD_MAX_ELEMS:
                        raise _FoldAbort(n)
                    # numpy has no bfloat16: such a value stays an op
                    out[n] = v.detach().numpy().copy()
            return out
        except Exception:
            aborted.update(n for n in op.output_arg_names() if n)
            raise

    out_ops: List[OpDesc] = []
    folded = 0
    for op in ops:
        det = _deterministic(op) and all(
            writers.get(n, 0) <= 1 for n in op.output_arg_names() if n)
        ins_names = [n for n in op.input_arg_names() if n]
        if det and op.type in _CONST_SRC and not ins_names:
            # candidate source: kept as-is; evaluated only if a
            # downstream fold pulls on it, dropped by DCE if that fold
            # orphans it
            for n in op.output_arg_names():
                if n:
                    producer[n] = op
            out_ops.append(op)
            continue
        if (det and op.type in _FOLDABLE and ins_names
                and all(n in producer or n in const_vals
                        for n in ins_names)):
            try:
                vals = evaluate(op)
            except Exception:  # noqa: BLE001 - folding is best-effort
                # past the literal-size cap or not evaluable here: keep
                # the op, and its outputs stop counting as constants
                out_ops.append(op)
                continue
            const_vals.update(vals)
            folded += 1
            for n, v in vals.items():
                out_ops.append(OpDesc(
                    "pt_const", {}, {"Out": [n]},
                    {"value": v,
                     OP_ROLE_ATTR_NAME: op.attrs.get(OP_ROLE_ATTR_NAME, 0)}))
            continue
        out_ops.append(op)
    return out_ops, folded


def cse_ops(ops: List[OpDesc], needed: Set[str]
            ) -> Tuple[List[OpDesc], int]:
    """Common-subexpression elimination over (op_type, inputs at their
    current WRITE VERSION, canonical attrs): the second op computing an
    identical value is dropped and later readers renamed onto the
    first's outputs. Inputs are keyed (name, version), so two reads of a
    parameter straddling its optimizer update never merge. Only
    single-writer outputs participate, RNG ops never merge, and an op
    whose output is needed BY NAME (fetch / persistable state) is kept
    so the name stays bound."""
    writers = analyze.writer_counts(ops)
    version: Dict[str, int] = {}  # writes seen so far, per var
    seen: Dict[tuple, OpDesc] = {}
    rename: Dict[str, str] = {}
    out_ops: List[OpDesc] = []
    removed = 0
    for op in ops:
        op = _clone_with_renamed_inputs(op, rename)
        outs = [n for n in op.output_arg_names() if n]
        eligible = (_deterministic(op) and outs
                    and all(writers.get(n, 0) == 1 for n in outs)
                    and not any(n in needed for n in outs))
        if not eligible:
            out_ops.append(op)
            for n in outs:
                version[n] = version.get(n, 0) + 1
            continue
        key = (op.type,
               tuple(sorted(
                   (s, tuple((n, version.get(n, 0)) for n in names))
                   for s, names in op.inputs.items())),
               tuple(sorted(op.outputs.keys())),
               _canon_attrs(op.attrs))
        kept = seen.get(key)
        if kept is None:
            seen[key] = op
            out_ops.append(op)
            for n in outs:
                version[n] = version.get(n, 0) + 1
            continue
        removed += 1
        for slot, names in op.outputs.items():
            for dup, orig in zip(names, kept.outputs.get(slot, [])):
                if dup and orig and dup != orig:
                    rename[dup] = orig
    return out_ops, removed


def dead_op_elimination(ops: List[OpDesc], needed: Set[str]
                        ) -> Tuple[List[OpDesc], int]:
    """Backward-sweep prune (framework/prune.cc:181 analog): drop ops
    reaching neither a fetch nor persistable/downstream state. RNG ops
    and ops that are not deterministic are kept even when dead."""
    live = set(needed)
    kept: List[OpDesc] = []
    for op in reversed(ops):
        outs = set(op.output_arg_names())
        if outs & live or _needs_rng(op) or not _deterministic(op):
            kept.append(op)
            live.update(n for n in op.input_arg_names() if n)
    kept.reverse()
    return kept, len(ops) - len(kept)


_ELEWISE_ACTS = ("relu", "sigmoid", "tanh", "scale")


def fuse_elewise_add_act_ops(ops: List[OpDesc], needed: Set[str]
                             ) -> Tuple[List[OpDesc], int]:
    """fuse_elewise_add_act_pass.cc applied to forward+backward lists.

    add(x, y) -> act          => UnaryCompound  [act, elementwise_add]
    act(y) -> add(x, act_out) => BinaryCompound [elementwise_add, act]

    The intermediate may have other consumers (the backward reads
    add_out/act_out): the fused op still emits IntermediateOut under the
    original name, and fusing at the earlier slot only moves production
    earlier, which SSA consumers cannot observe."""
    du = analyze.DefUse(ops)
    writers = du.writer_counts()
    readers = du.readers
    write_pos = du.writers

    drop: Set[int] = set()
    fused_at: Dict[int, OpDesc] = {}
    fused = 0
    for i, op in enumerate(ops):
        if i in drop or i in fused_at:
            continue
        # forward shape: add at i, act consumes add_out later
        if op.type == "elementwise_add":
            add_out = op.output("Out")[0]
            if writers.get(add_out, 0) != 1:
                continue
            for j in readers.get(add_out, []):
                if j <= i or j in drop or j in fused_at:
                    continue
                act = ops[j]
                if (act.type not in _ELEWISE_ACTS
                        or act.input("X") != [add_out]
                        or len(act.input_arg_names()) != 1):
                    continue
                if act.type == "scale" and float(
                        act.attrs.get("bias", 0.0)) != 0.0:
                    continue
                act_out = act.output("Out")[0]
                if writers.get(act_out, 0) != 1:
                    continue
                attrs = {"functor_list": [act.type, "elementwise_add"],
                         "axis": int(op.attrs.get("axis", -1)),
                         OP_ROLE_ATTR_NAME:
                             op.attrs.get(OP_ROLE_ATTR_NAME, 0)}
                if act.type == "scale":
                    attrs["scale"] = float(act.attrs.get("scale", 1.0))
                fused_at[i] = OpDesc(
                    "fused_elemwise_activation",
                    {"X": list(op.input("X")), "Y": list(op.input("Y"))},
                    {"Out": [act_out], "IntermediateOut": [add_out]},
                    attrs)
                drop.add(j)
                fused += 1
                break
            continue
        # reverse shape: act at i, add consumes act_out on its Y side.
        # Fused at the ADD slot (x may be produced between act and add),
        # so act_out moves LATER: it must have no other consumer.
        if op.type in _ELEWISE_ACTS:
            if (len(op.input_arg_names()) != 1
                    or (op.type == "scale"
                        and float(op.attrs.get("bias", 0.0)) != 0.0)):
                continue
            act_out = op.output("Out")[0]
            if writers.get(act_out, 0) != 1:
                continue
            cons = readers.get(act_out, [])
            if len(cons) != 1 or act_out in needed:
                continue
            j = cons[0]
            if j <= i or j in drop or j in fused_at:
                continue
            # the fused op reads the act's input at the LATER add slot:
            # any write of it between the two slots (the parameter's
            # optimizer update) would make the moved read see the new
            # value
            if any(i < w <= j for w in write_pos.get(op.input("X")[0],
                                                    ())):
                continue
            add = ops[j]
            if (add.type != "elementwise_add"
                    or add.input("Y") != [act_out]):
                continue
            add_out = add.output("Out")[0]
            if writers.get(add_out, 0) != 1:
                continue
            attrs = {"functor_list": ["elementwise_add", op.type],
                     "axis": int(add.attrs.get("axis", -1)),
                     OP_ROLE_ATTR_NAME:
                         add.attrs.get(OP_ROLE_ATTR_NAME, 0)}
            if op.type == "scale":
                attrs["scale"] = float(op.attrs.get("scale", 1.0))
            fused_at[j] = OpDesc(
                "fused_elemwise_activation",
                {"X": list(add.input("X")), "Y": list(op.input("X"))},
                {"Out": [add_out], "IntermediateOut": [act_out]},
                attrs)
            drop.add(i)
            fused += 1
    if not fused:
        return list(ops), 0
    out_ops = []
    for i, op in enumerate(ops):
        if i in drop:
            continue
        out_ops.append(fused_at.get(i, op))
    return out_ops, fused


def fuse_optimizer_ops(ops: List[OpDesc], needed: Set[str],
                       var_dtype: Optional[Callable[[str], Any]] = None
                       ) -> Tuple[List[OpDesc], int]:
    """fuse_all_optimizer_ops: the grouping and rewrite live in
    optimizer.fuse_optimizer_update_ops (optimizer.py owns which update
    ops fuse and their slots; ops/kernels_optim.py the fused emitter)."""
    from ..optimizer import fuse_optimizer_update_ops
    return fuse_optimizer_update_ops(ops, var_dtype=var_dtype)


# ---------------------------------------------------------------------------
# attention fusion
# ---------------------------------------------------------------------------

def _var_shape(block, name) -> Optional[List[int]]:
    try:
        return list(block.var(name).desc.shape or [])
    except Exception:  # noqa: BLE001 - metadata lookup, best effort
        return None


def _persistable_1d(block, name) -> bool:
    """True when `name` is a persistable per-channel vector: the only Y
    an elementwise_add may carry to count as a conv bias (the fused
    emitter re-emits the same axis=1 broadcast)."""
    try:
        v = block.vars[name]
        return bool(v.persistable and len(v.desc.shape or []) == 1)
    except Exception:  # noqa: BLE001 - metadata lookup, best effort
        return False


def _fuse_chain_with_backward(ops: List[OpDesc], fwd_idx: List[int],
                              fused_fwd: OpDesc, out_slot: str,
                              interior: Set[str], needed: Set[str],
                              aux_in: Set[str] = frozenset(),
                              dropped_outs: Set[str] = frozenset()):
    """Replace a matched forward chain AND its backward twin with one
    fused op each, or return None when the rewrite cannot be proven
    safe.

    The legality rule is containment: every op outside the matched
    forward set that touches an interior var (or its @GRAD) must be a
    ``<chain member type>_grad`` op whose names all stay inside the
    chain's interior/boundary universe, i.e. exactly the default-vjp grad
    twins append_backward wrote for the matched ops. The fused backward
    desc is the default-vjp grad of the FUSED op (same ``<slot>@GRAD``
    naming), so downstream grad consumers see the names they always
    did. ``aux_in`` names chain inputs the fused op does NOT take (mask
    constants): legal to read, illegal to grad. ``dropped_outs`` are
    chain outputs the fused op stops producing (inference batch_norm's
    identity MeanOut/VarianceOut): legal only while nothing reads
    them."""
    if interior & needed:
        return None
    fwd_set = set(fwd_idx)
    chain_types = {ops[i].type for i in fwd_idx}
    du = analyze.DefUse(ops)
    if not all(du.single_writer(n) for n in interior):
        return None
    out_name = fused_fwd.output(out_slot)[0]
    boundary_in = [n for ns in fused_fwd.inputs.values() for n in ns if n]
    boundary = set(boundary_in) | {out_name} | set(aux_in)
    interior_g = {n + GRAD_SUFFIX for n in interior}
    boundary_g = {n + GRAD_SUFFIX for n in boundary}
    allowed = interior | interior_g | boundary | boundary_g | {""}
    watched = interior | interior_g | set(dropped_outs)

    def _allowed(n):
        # a boundary input shared by several chains gets RENAME'd
        # per-chain grad contributions (backward.py's sum op); this
        # chain's contribution is still its own to produce
        if n in allowed:
            return True
        return n.split("@RENAME@")[0] in boundary_g

    grad_set: Set[int] = set()
    for j, op in enumerate(ops):
        if j in fwd_set:
            continue
        names = set(op.input_arg_names()) | set(op.output_arg_names())
        if not names & watched:
            continue
        base = (op.type[:-len("_grad")]
                if op.type.endswith("_grad") else None)
        if base is None or base not in chain_types:
            return None  # a non-grad consumer of an interior var
        if not all(_allowed(n) for n in names):
            return None  # grad twin reaches outside the chain universe
        grad_set.add(j)

    # aux inputs (mask constants) have no grad slot on the fused op:
    # their chain-produced cotangents may only vanish if nothing reads
    # them
    aux_g = {n + GRAD_SUFFIX for n in aux_in}
    for j in grad_set:
        for o in ops[j].output_arg_names():
            if o and o.split("@RENAME@")[0] in aux_g \
                    and du.read_positions(o):
                return None

    # the fused op reads each input at the LAST matched slot, so no
    # write of it may land between its first matched read and there
    if not du.moved_reads_safe(boundary_in, fwd_idx, max(fwd_idx)):
        return None
    fused_grad = None
    if grad_set:
        produced: Set[str] = set()
        role_vars: List[str] = []
        for j in sorted(grad_set):
            produced.update(n for n in ops[j].output_arg_names() if n)
            role_vars.extend(
                ops[j].attrs.get(OP_ROLE_VAR_ATTR_NAME) or [])
        g_inputs = {s: list(ns) for s, ns in fused_fwd.inputs.items()}
        g_inputs[out_slot + GRAD_SUFFIX] = [out_name + GRAD_SUFFIX]

        def _grad_out(n):
            """The grad name this chain's twins produced for input `n`:
            the plain ``n@GRAD``, or the one RENAME'd contribution when
            `n` is shared across chains."""
            if not n:
                return ""
            cands = [p for p in produced
                     if p == n + GRAD_SUFFIX
                     or p.split("@RENAME@")[0] == n + GRAD_SUFFIX
                     and "@RENAME@" in p]
            if len(cands) != 1:
                return "" if not cands else None
            return cands[0]

        g_outputs = {}
        for s, ns in fused_fwd.inputs.items():
            outs = [_grad_out(n) for n in ns]
            if any(o is None for o in outs):
                return None  # ambiguous contributions: stay unfused
            g_outputs[s + GRAD_SUFFIX] = outs
        if not any(n for ns in g_outputs.values() for n in ns):
            return None  # twins matched but produce nothing kept
        g_attrs = dict(fused_fwd.attrs)
        g_attrs["__fwd_type__"] = fused_fwd.type
        g_attrs[OP_ROLE_ATTR_NAME] = int(OpRole.BACKWARD)
        if role_vars:
            g_attrs[OP_ROLE_VAR_ATTR_NAME] = role_vars
        fused_grad = OpDesc(fused_fwd.type + "_grad", g_inputs,
                            g_outputs, g_attrs)
        # the fused grad reads the forward inputs + the out cotangent at
        # the LAST matched grad slot
        if not du.moved_reads_safe(
                boundary_in + [out_name + GRAD_SUFFIX],
                sorted(grad_set), max(grad_set)):
            return None

    drop = fwd_set | grad_set
    out_ops: List[OpDesc] = []
    for j, op in enumerate(ops):
        if j == max(fwd_idx):
            out_ops.append(fused_fwd)
        elif grad_set and j == max(grad_set):
            out_ops.append(fused_grad)
        elif j in drop:
            continue
        else:
            out_ops.append(op)
    removed = len(drop) - 1 - (1 if grad_set else 0)
    return out_ops, removed


def _causal_mask_value(op) -> bool:
    """True when an assign_value op holds the strict-upper-triangular
    -1e9 causal bias (models/transformer.py _causal_add)."""
    shape = list(op.attrs.get("shape", ()))
    if len(shape) != 2 or shape[0] != shape[1]:
        return False
    try:
        vals = np.asarray(op.attrs["values"], np.float32).reshape(shape)
    except Exception:  # noqa: BLE001
        return False
    t = shape[0]
    return bool(np.array_equal(
        vals, np.triu(np.full((t, t), -1e9, np.float32), k=1)))


def fuse_attention_chain_ops(ops: List[OpDesc], needed: Set[str], block
                             ) -> Tuple[List[OpDesc], int]:
    """Rewrite the unfused attention chain the frontend emits,
    matmul(QK^T, scaled) -> [key-bias add] -> [causal-mask add] ->
    softmax -> [identity dropout] -> matmul(PV), into the
    ``flash_attention`` op (ops/flash_attention.py: the hand CUDA kernel
    on the card), and its grad twins into one ``flash_attention_grad``.
    The [Tq, Tk] scores stop materializing.

    Matched mask shapes (the two the models emit):
      - key bias: elementwise_add whose Y is unsqueeze2(unsqueeze2(kb))
        of a rank-2 [B, Tk] additive mask -> the op's KeyBias input
      - causal: elementwise_add whose Y is an assign_value holding the
        strict-upper-triangular -1e9 matrix -> causal=True
    A dense [B, H, Tq, Tk] attn_bias has no flash lowering and leaves
    the chain alone. Scale folds from the matmul alpha and any bias-free
    scale op adjacent to the scores before a mask lands. Dropout only
    matches in its is_test/upscale_in_train identity form. Numerics are
    bit-close, not bit-exact: the fused op reassociates the scale and
    computes the masked softmax in fp32."""
    total = 0
    changed = True
    while changed:
        changed = False
        readers = analyze.read_positions(ops)
        writers = analyze.write_positions(ops)
        producer = {}
        for i, op in enumerate(ops):
            for n in op.output_arg_names():
                if n and len(writers.get(n, ())) == 1:
                    producer[n] = i

        def single_reader(name, after):
            rs = [r for r in readers.get(name, ())
                  if r > after and not ops[r].type.endswith("_grad")]
            return rs[0] if len(rs) == 1 else None

        for i, m1 in enumerate(ops):
            if m1.type != "matmul" \
                    or not m1.attrs.get("transpose_Y", False) \
                    or m1.attrs.get("transpose_X", False):
                continue
            q, k = m1.input("X")[0], m1.input("Y")[0]
            scale = float(m1.attrs.get("alpha", 1.0))
            fwd_idx = [i]
            interior: Set[str] = set()
            aux: Set[str] = set()
            # fold a bias-free scale feeding Q (it multiplies the scores
            # linearly through the matmul)
            qp = producer.get(q)
            if qp is not None and ops[qp].type == "scale" \
                    and float(ops[qp].attrs.get("bias", 0.0)) == 0.0 \
                    and single_reader(q, qp) == i and q not in needed:
                scale *= float(ops[qp].attrs.get("scale", 1.0))
                interior.add(q)
                fwd_idx.append(qp)
                q = ops[qp].input("X")[0]
            qs = _var_shape(block, q)
            ks = _var_shape(block, k)
            if not (qs and ks and len(qs) == 4 and len(ks) == 4):
                continue  # flash_attention takes [B, H, T, D] heads
            cur = m1.output("Out")[0]
            causal = False
            key_bias = None
            masked = False
            ok = True
            while True:
                j = single_reader(cur, max(fwd_idx))
                if j is None or cur in needed:
                    ok = False
                    break
                nxt = ops[j]
                if nxt.type == "softmax":
                    if int(nxt.attrs.get("axis", -1)) not in (-1, 3):
                        ok = False
                    else:
                        interior.add(cur)
                        fwd_idx.append(j)
                        cur = nxt.output("Out")[0]
                    break
                if nxt.type == "scale" and not masked \
                        and float(nxt.attrs.get("bias", 0.0)) == 0.0 \
                        and nxt.input("X") == [cur]:
                    scale *= float(nxt.attrs.get("scale", 1.0))
                    interior.add(cur)
                    fwd_idx.append(j)
                    cur = nxt.output("Out")[0]
                    continue
                if nxt.type == "elementwise_add" \
                        and nxt.input("X") == [cur] \
                        and int(nxt.attrs.get("axis", -1)) == -1:
                    y = nxt.input("Y")[0]
                    yp = producer.get(y)
                    if yp is not None and ops[yp].type == "assign_value" \
                            and _causal_mask_value(ops[yp]) \
                            and not causal:
                        causal = True
                        aux.add(y)
                    else:
                        kb = _key_bias_source(ops, producer, y, block)
                        if kb is None or key_bias is not None:
                            ok = False
                            break
                        key_bias, unsq_idx = kb
                        # the unsqueeze twins join the fusion: the fused
                        # flash_attention_grad produces the 2-D
                        # KeyBias@GRAD under the same name
                        for u in unsq_idx:
                            fwd_idx.append(u)
                            interior.update(
                                n for n in ops[u].output_arg_names() if n)
                    masked = True
                    interior.add(cur)
                    fwd_idx.append(j)
                    cur = nxt.output("Out")[0]
                    continue
                ok = False
                break
            if not ok:
                continue
            # optional inference-identity dropout between softmax and PV
            j = single_reader(cur, max(fwd_idx))
            if j is not None and ops[j].type == "dropout":
                d = ops[j]
                if not (d.attrs.get("is_test")
                        and d.attrs.get("dropout_implementation")
                        == "upscale_in_train"):
                    continue  # training dropout: no flash lowering
                interior.add(cur)
                interior.update(n for n in d.output("Mask") if n)
                fwd_idx.append(j)
                cur = d.output("Out")[0]
                j = single_reader(cur, max(fwd_idx))
            if j is None:
                continue
            m2 = ops[j]
            if m2.type != "matmul" or m2.input("X") != [cur] \
                    or m2.attrs.get("transpose_X") \
                    or m2.attrs.get("transpose_Y") \
                    or float(m2.attrs.get("alpha", 1.0)) != 1.0 \
                    or cur in needed:
                continue
            v = m2.input("Y")[0]
            vs = _var_shape(block, v)
            if not (vs and len(vs) == 4):
                continue
            interior.add(cur)
            fwd_idx.append(j)
            out = m2.output("Out")[0]
            ins = {"Q": [q], "K": [k], "V": [v]}
            if key_bias is not None:
                ins["KeyBias"] = [key_bias]
            fused = OpDesc(
                "flash_attention", ins, {"Out": [out]},
                {"causal": bool(causal), "scale": float(scale),
                 OP_ROLE_ATTR_NAME: m1.attrs.get(OP_ROLE_ATTR_NAME, 0)})
            res = _fuse_chain_with_backward(
                ops, sorted(fwd_idx), fused, "Out", interior, needed,
                aux_in=aux)
            if res is not None:
                ops, removed = res
                total += removed
                changed = True
                break
    return ops, total


def _key_bias_source(ops, producer, y, block):
    """(rank-2 [B, Tk] source, [unsqueeze op indices]) behind an
    unsqueeze2(unsqueeze2(kb)) broadcast-mask chain, or None when `y` is
    anything else (a dense attn_bias has no flash lowering)."""
    cur = y
    idx = []
    for _ in range(2):
        p = producer.get(cur)
        if p is None or ops[p].type not in ("unsqueeze2", "unsqueeze"):
            return None
        if list(ops[p].attrs.get("axes", ())) != [1]:
            return None
        idx.append(p)
        cur = ops[p].input("X")[0]
    shape = _var_shape(block, cur)
    if shape is None or len(shape) != 2:
        return None
    return cur, idx


# ---------------------------------------------------------------------------
# conv fusions
# ---------------------------------------------------------------------------

_CONV_TYPES = ("conv2d", "depthwise_conv2d")
_CONV_ACTS = ("relu", "sigmoid", "tanh")


def _match_conv_bias(ops, i, readers, writers, block):
    """The conv at `i` followed by its per-channel bias add, if any:
    (add index or None, the biased output's name)."""
    conv_out = ops[i].output("Output")[0]
    for j in readers.get(conv_out, ()):
        if j <= i:
            continue
        add = ops[j]
        if (add.type == "elementwise_add"
                and add.input("X") == [conv_out]
                and int(add.attrs.get("axis", -1)) == 1
                and len(add.input("Y")) == 1
                and _persistable_1d(block, add.input("Y")[0])
                and len(writers.get(add.output("Out")[0], ())) == 1):
            return j, add.output("Out")[0]
        break
    return None, conv_out


def fuse_conv_bn_ops(ops: List[OpDesc], needed: Set[str], block
                     ) -> Tuple[List[OpDesc], int]:
    """conv_bn_fuse_pass.cc at the op-list level, for inference lists
    only (no grad ops): conv2d [+ bias add] + inference-mode batch_norm
    [+ act] become ONE ``fused_conv2d`` that takes the statistics as live
    inputs. Unlike the registry pass (ir/passes.py ConvBNFusePass)
    nothing is folded by value, so a reloaded checkpoint keeps working;
    the fused emitter composes the unfused emitters, so fetches are the
    unfused program's. Dropping the batch_norm drops its MeanOut and
    VarianceOut writes, which are identity updates in inference mode,
    and is refused while anything reads them or a fetch names its
    SavedMean or SavedVariance (temporaries with no scope fallback)."""
    if any(op.type.endswith("_grad") for op in ops):
        return list(ops), 0
    total = 0
    changed = True
    while changed:
        changed = False
        readers = analyze.read_positions(ops)
        writers = analyze.write_positions(ops)
        for i, conv in enumerate(ops):
            if conv.type not in _CONV_TYPES \
                    or conv.attrs.get("fuse_relu_before_depthwise_conv"):
                continue
            add_idx, cur = _match_conv_bias(ops, i, readers, writers, block)
            bn_idx = None
            for j in readers.get(cur, ()):
                if j > i and ops[j].type == "batch_norm" \
                        and ops[j].input("X") == [cur]:
                    bn_idx = j
                break
            if bn_idx is None:
                continue
            bn = ops[bn_idx]
            if not (bn.attrs.get("is_test")
                    or bn.attrs.get("use_global_stats")):
                continue
            if bn.attrs.get("data_layout", "NCHW") != conv.attrs.get(
                    "data_format", "NCHW"):
                continue
            bn_y = bn.output("Y")[0]
            side = [n for s in ("MeanOut", "VarianceOut", "SavedMean",
                                "SavedVariance")
                    for n in bn.output(s) if n]
            if any(r > bn_idx for n in side for r in readers.get(n, ())):
                continue
            if any(n in needed for s in ("SavedMean", "SavedVariance")
                   for n in bn.output(s) if n):
                continue
            act_idx = None
            out = bn_y
            rs = [r for r in readers.get(bn_y, ()) if r > bn_idx]
            if len(rs) == 1 and ops[rs[0]].type in _CONV_ACTS \
                    and ops[rs[0]].input("X") == [bn_y] \
                    and bn_y not in needed:
                act_idx = rs[0]
                out = ops[act_idx].output("Out")[0]
            ins = {"Input": list(conv.input("Input")),
                   "Filter": list(conv.input("Filter")),
                   "Scale": list(bn.input("Scale")),
                   "BNBias": list(bn.input("Bias")),
                   "Mean": list(bn.input("Mean")),
                   "Variance": list(bn.input("Variance"))}
            fwd_idx = [i, bn_idx]
            interior = {conv.output("Output")[0]}
            if add_idx is not None:
                ins["Bias"] = list(ops[add_idx].input("Y"))
                fwd_idx.append(add_idx)
                interior.add(cur)
            if act_idx is not None:
                fwd_idx.append(act_idx)
                interior.add(bn_y)
            fused = OpDesc(
                "fused_conv2d", ins, {"Output": [out]},
                dict(conv.attrs, conv_type=conv.type,
                     activation=(ops[act_idx].type if act_idx is not None
                                 else "identity"),
                     epsilon=float(bn.attrs.get("epsilon", 1e-5)),
                     with_bn=True))
            res = _fuse_chain_with_backward(
                ops, sorted(fwd_idx), fused, "Output", interior, needed,
                dropped_outs=set(side))
            if res is not None:
                ops, removed = res
                total += removed
                changed = True
                break
    return ops, total


def fuse_conv_epilogue_ops(ops: List[OpDesc], needed: Set[str], block
                           ) -> Tuple[List[OpDesc], int]:
    """conv_elementwise_add_act_fuse_pass.cc for training lists: conv2d
    + elementwise_add (per-channel persistable bias, axis=1) + act
    become one ``fused_conv2d``, forward and backward (the three
    default-vjp grad twins collapse into one ``fused_conv2d_grad``, the
    generic vjp of the fused emitter). Values and gradients are the
    unfused program's."""
    total = 0
    changed = True
    while changed:
        changed = False
        readers = analyze.read_positions(ops)
        writers = analyze.write_positions(ops)
        for i, conv in enumerate(ops):
            if conv.type not in _CONV_TYPES \
                    or conv.attrs.get("fuse_relu_before_depthwise_conv"):
                continue
            add_idx, add_out = _match_conv_bias(ops, i, readers, writers,
                                                block)
            if add_idx is None:
                continue
            rs = [r for r in readers.get(add_out, ())
                  if r > add_idx and not ops[r].type.endswith("_grad")]
            if len(rs) != 1 or ops[rs[0]].type not in _CONV_ACTS \
                    or ops[rs[0]].input("X") != [add_out] \
                    or add_out in needed:
                continue
            act_idx = rs[0]
            fused = OpDesc(
                "fused_conv2d",
                {"Input": list(conv.input("Input")),
                 "Filter": list(conv.input("Filter")),
                 "Bias": list(ops[add_idx].input("Y"))},
                {"Output": [ops[act_idx].output("Out")[0]]},
                dict(conv.attrs, conv_type=conv.type,
                     activation=ops[act_idx].type))
            res = _fuse_chain_with_backward(
                ops, [i, add_idx, act_idx], fused, "Output",
                {conv.output("Output")[0], add_out}, needed)
            if res is not None:
                ops, removed = res
                total += removed
                changed = True
                break
    return ops, total


# ---------------------------------------------------------------------------
# NHWC layout, forward and backward
# ---------------------------------------------------------------------------

# layout-aware op -> (main input slot, main output slot, format attr)
_LAYOUT_OPS = {"conv2d": ("Input", "Output", "data_format"),
               "depthwise_conv2d": ("Input", "Output", "data_format"),
               "fused_conv2d": ("Input", "Output", "data_format"),
               "pool2d": ("X", "Out", "data_format"),
               "batch_norm": ("X", "Y", "data_layout")}
# elementwise glue that runs the same in either layout once every 4-D
# operand is NHWC; "sum" is append_backward's accumulation of the
# gradients of spine vars with several consumers (the residual
# shortcut). A training dropout is not glue: its mask draws over the
# tensor's shape, so a transposed draw is another mask; only the
# is_test identity passes through (special-cased below).
_LAYOUT_PASSTHRU = ("relu", "relu6", "sigmoid", "tanh", "leaky_relu",
                    "elementwise_add", "elementwise_mul",
                    "scale", "hard_swish", "swish", "sum")


def conv_layout_nhwc_ops(ops: List[OpDesc], needed: Set[str], block
                         ) -> Tuple[List[OpDesc], int]:
    """Rewrite the NCHW conv/pool/batch_norm spine of an op list to NHWC,
    the backward half included (the build-time pass, ir/passes.py
    ConvLayoutNHWCPass, runs before append_backward and never sees it).
    A grad twin rewritten to the NHWC format with its main input and
    cotangent swapped to the NHWC twins computes in NHWC; filters,
    scales and their gradients keep their layout-free shapes (OIHW,
    [C]), so the optimizer and checkpoints never see the layout.

    Any op the pass does not understand reads the original NCHW value: a
    transpose materializes it right before that consumer. Wrong layouts
    cannot arise; unknown ops only cost a transpose. Lists with fewer
    than 2 NCHW conv ops are left alone (one spine pays a transpose each
    way, which a lone conv does not repay)."""
    spine = sum(1 for op in ops
                if op.type in _CONV_TYPES + ("fused_conv2d",)
                and op.attrs.get("data_format", "NCHW") == "NCHW")
    if spine < 2:
        return list(ops), 0

    nhwc_of: Dict[str, str] = {}   # NCHW var -> its current NHWC twin
    back_done: Set[str] = set()
    rewritten: Set[str] = set()    # NCHW names with no NCHW producer
    twin_seq: Dict[str, int] = {}
    new_ops: List[OpDesc] = []
    count = 0

    def rank(name: str) -> Optional[int]:
        base = name.split(GRAD_SUFFIX)[0] if GRAD_SUFFIX in name else name
        shape = _var_shape(block, base)
        return len(shape) if shape else None

    def rank4(name: str) -> bool:
        return rank(name) == 4

    def to_nhwc(name: str) -> str:
        if name in nhwc_of:
            return nhwc_of[name]
        twin = name + "@NHWC"
        new_ops.append(OpDesc("transpose", {"X": [name]},
                              {"Out": [twin]}, {"axis": [0, 2, 3, 1]}))
        nhwc_of[name] = twin
        return twin

    def back_to_nchw(name: str):
        if name in back_done:
            return
        new_ops.append(OpDesc("transpose", {"X": [nhwc_of[name]]},
                              {"Out": [name]}, {"axis": [0, 3, 1, 2]}))
        back_done.add(name)

    def twin_out(name: str) -> str:
        """A fresh twin for a WRITE of `name`: a name written again (a
        gradient accumulated into the same @GRAD name) gets a versioned
        twin, and later reads resolve through the current mapping, as
        the executor rebinds names in order."""
        k = twin_seq.get(name, 0)
        twin_seq[name] = k + 1
        twin = name + "@NHWC" + (f"@{k}" if k else "")
        nhwc_of[name] = twin
        rewritten.add(name)
        back_done.discard(name)
        return twin

    def remap_axis(tensor_names, attrs) -> Optional[Dict]:
        """Mixed ranks: only the per-channel rank-1 broadcast on axis 1
        survives the layout change (the channel moves last: axis -1);
        anything else keeps the op in NCHW."""
        low = [n for n in tensor_names if not rank4(n)]
        if not low:
            return attrs
        if all(rank(n) == 1 for n in low) and attrs.get("axis", -1) == 1:
            return dict(attrs, axis=-1)
        return None

    def invalidate(op):
        """An op kept in NCHW rebinds its outputs: their twins are
        stale."""
        for n in op.output_arg_names():
            if n and n in nhwc_of:
                del nhwc_of[n]
                rewritten.discard(n)
                back_done.discard(n)

    for op in ops:
        info = _LAYOUT_OPS.get(op.type)
        if info is not None \
                and op.attrs.get(info[2], "NCHW") == "NCHW" \
                and rank4(op.input(info[0])[0]):
            in_slot, out_slot, fmt = info
            inputs = {s: list(ns) for s, ns in op.inputs.items()}
            outputs = {s: list(ns) for s, ns in op.outputs.items()}
            inputs[in_slot] = [to_nhwc(op.input(in_slot)[0])]
            out = op.output(out_slot)[0]
            outputs[out_slot] = [twin_out(out)]
            new_ops.append(OpDesc(op.type, inputs, outputs,
                                  dict(op.attrs, **{fmt: "NHWC"})))
            count += 1
            if out in needed:
                back_to_nchw(out)
            continue
        base = (op.type[:-len("_grad")]
                if op.type.endswith("_grad") else None)
        ginfo = _LAYOUT_OPS.get(base) if base else None
        if ginfo is not None \
                and op.attrs.get(ginfo[2], "NCHW") == "NCHW" \
                and op.input(ginfo[0]) \
                and op.input(ginfo[0])[0] in nhwc_of:
            # grad twin of a rewritten layout op: the main input and its
            # cotangent go NHWC, the main input's gradient comes out
            # NHWC; filter/scale slots and their grads are layout-free
            in_slot, out_slot, fmt = ginfo
            og_slot = out_slot + GRAD_SUFFIX
            ig_slot = in_slot + GRAD_SUFFIX
            og = op.input(og_slot)
            ig = op.output(ig_slot) if ig_slot in op.outputs else []
            if not og or not rank4(og[0]):
                invalidate(op)
                new_ops.append(op)
                continue
            inputs = {s: list(ns) for s, ns in op.inputs.items()}
            outputs = {s: list(ns) for s, ns in op.outputs.items()}
            inputs[in_slot] = [nhwc_of[op.input(in_slot)[0]]]
            inputs[og_slot] = [to_nhwc(og[0])]
            if ig and ig[0]:
                outputs[ig_slot] = [twin_out(ig[0])]
            new_ops.append(OpDesc(op.type, inputs, outputs,
                                  dict(op.attrs, **{fmt: "NHWC"})))
            count += 1
            if ig and ig[0] and ig[0] in needed:
                back_to_nchw(ig[0])
            continue
        pbase = op.type if op.type in _LAYOUT_PASSTHRU else base
        is_identity_dropout = ((op.type == "dropout" or base == "dropout")
                               and op.attrs.get("is_test"))
        if pbase in _LAYOUT_PASSTHRU or is_identity_dropout:
            tensor_ins = [n for s in op.inputs for n in op.inputs[s] if n]
            four_d = [n for n in tensor_ins if rank4(n)]
            # forward vars must already be twinned (their producer was
            # rewritten); cotangents may be transposed in at the spine's
            # end, as the forward's single entry transpose
            fwd_4d = [n for n in four_d if GRAD_SUFFIX not in n]
            outs_4d = [n for s in op.outputs for n in op.outputs[s]
                       if n and rank4(n)]
            if fwd_4d:
                ok = all(n in nhwc_of for n in fwd_4d)
            else:
                # only cotangents (a gradient `sum`): at least one must be
                # NHWC already, or a whole NCHW chain is transposed in for
                # nothing
                ok = (bool(four_d) and bool(outs_4d)
                      and any(n in nhwc_of for n in four_d))
            attrs = dict(op.attrs)
            if ok:
                remapped = remap_axis(tensor_ins, attrs)
                ok = remapped is not None
                attrs = remapped if ok else attrs
            if ok and op.type == "sum":
                ok = all(rank4(n) for n in tensor_ins)
            if ok:
                inputs = {s: [(nhwc_of[n] if n in nhwc_of else to_nhwc(n))
                              if n and rank4(n) else n
                              for n in op.inputs[s]] for s in op.inputs}
                outputs = {s: [twin_out(n) if n and rank4(n) else n
                               for n in op.outputs[s]] for s in op.outputs}
                new_ops.append(OpDesc(op.type, inputs, outputs, attrs))
                count += 1
                for n in outs_4d:
                    if n in needed:
                        back_to_nchw(n)
                continue
        # a layout-oblivious consumer: materialize NCHW for any input
        # whose producer now emits only the NHWC twin
        for n in set(op.input_arg_names()):
            if n in rewritten and n not in back_done:
                back_to_nchw(n)
        invalidate(op)
        new_ops.append(op)
    for n in sorted(rewritten):
        if n not in back_done and n in needed:
            back_to_nchw(n)
    return new_ops, count


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------



def block_var_dtype(block) -> Callable[[str], Optional[str]]:
    """name -> numpy-dtype-string lookup over a frontend Block: the
    optimizer fuse's grouping key (None isolates the op from fusion)."""
    from ..core.types import dtype_to_numpy

    def var_dtype(name):
        try:
            v = block.vars[name]
            return (str(np.dtype(dtype_to_numpy(v.desc.dtype)))
                    if v.desc.dtype is not None else None)
        except Exception:  # noqa: BLE001 - grouping key, best effort
            return None
    return var_dtype


def run_pipeline(ops: List[OpDesc], block, needed: Set[str],
                 flags: Sequence[str],
                 stats: Optional[Dict[str, Dict[str, float]]] = None
                 ) -> List[OpDesc]:
    """Run the enabled pass groups over one op list and return the
    rewritten list (fresh descs where rewritten; the input list and its
    descs are never mutated). Stages run in the JAX package's order.
    With ``stats``, each stage adds its ``ops_removed`` and ``seconds``
    under its name (for the layout stage, the ops it rewrote)."""
    var_dtype = block_var_dtype(block)

    # order matters: the conv/attention matchers run on the rawest
    # structure (before slimming renames anything), the layout stage
    # rewrites the (possibly fused) conv spine before the elementwise
    # fusion, so the residual add + relu glue it twins are still plain
    # ops, and DCE sweeps the orphans (mask constants, unsqueeze chains,
    # unread layout twins) last
    stages: List[Tuple[str, Callable]] = []
    if "convfuse" in flags:
        stages.append(("fuse_conv_bn",
                       lambda o, n: fuse_conv_bn_ops(o, n, block)))
        stages.append(("fuse_conv_epilogue",
                       lambda o, n: fuse_conv_epilogue_ops(o, n, block)))
    if "attnfuse" in flags:
        stages.append(("fuse_attention",
                       lambda o, n: fuse_attention_chain_ops(o, n, block)))
    if "slim" in flags:
        stages.append(("constant_fold", constant_fold_ops))
        stages.append(("cse", cse_ops))
    if "nhwc" in flags:
        stages.append(("conv_layout_nhwc",
                       lambda o, n: conv_layout_nhwc_ops(o, n, block)))
    if "elewise" in flags:
        stages.append(("fuse_elewise_add_act", fuse_elewise_add_act_ops))
    if "optfuse" in flags:
        stages.append(("fuse_optimizer_ops",
                       lambda o, n: fuse_optimizer_ops(o, n, var_dtype)))
    if stages:
        stages.append(("dead_op_elimination", dead_op_elimination))

    for name, fn in stages:
        t0 = time.perf_counter()
        ops, n = fn(ops, needed)
        if stats is not None:
            row = stats.setdefault(name, {"ops_removed": 0, "seconds": 0.0})
            row["ops_removed"] += int(n)
            row["seconds"] += time.perf_counter() - t0
    return ops

"""Static program verifier: typed diagnostics over a ProgramDesc
(counterpart of ``paddle_tpu/ir/verify.py``).

Fluid's C++ runtime verified every op at InferShape time (op_desc.cc:649,
operator.cc InferShapeContext); a program the executor runs op by op
fails only at the op that breaks, with a stack that names no OpDesc.
This module closes that gap with three layers:

1. A **static abstract interpreter** (:func:`infer_block_types`) that
   walks OpDescs computing output shapes and dtypes from the per-op
   ``infer_shape`` rules registered beside each emitter in ``ops/``, with
   a generic fallback that runs the emitter itself on meta tensors (no
   storage, no kernels), and a zero-cost structural rule for grad twins
   (``<slot>@GRAD`` mirrors the forward input slot). Inferred types are
   compared with the declared VarDescs; a disagreement becomes a typed
   :class:`Diagnostic` naming the op, the var and the op's Python
   creation callstack.

2. A **checker battery** (:func:`verify_program`): undefined or
   never-written inputs, shape and dtype mismatches, double writers,
   donation safety (a var rewritten in place by an OPTIMIZE-role op and
   read later by another op), RNG hygiene (dead random ops that only
   survive to keep the generator's stream), grad-twin and
   ``op_role_var`` consistency, and a retrace-risk linter flagging the
   concat-grow KV-cache idiom (suggesting ``kv_cache_write``) and host
   ops that split a block.

3. **Pass-boundary invariants** (:func:`check_pass`): run after every
   ir/pipeline.py stage under ``FLAGS.verify_passes`` /
   ``build_strategy.verify_passes``: needed outputs kept, no new
   external reads, the random-op sequence unchanged, host ops intact, no
   new double writers. A violation raises :class:`PassVerifyError`
   naming the pass.

Verification is memoized per program version (the ``_version`` counter
that keys the executor's plans), so later runs pay one dict lookup.

The port compares dtypes in its own types (``DataType``), with no
int64-to-int32 folding: ids stay int64 (ROADMAP C, by design).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import registry
from ..core.desc import OpDesc, VarDesc
from ..core.types import (GRAD_SUFFIX, OP_ROLE_ATTR_NAME,
                          OP_ROLE_VAR_ATTR_NAME, OpRole, convert_dtype,
                          dtype_to_str, dtype_to_torch)
from . import analyze

__all__ = ["Diagnostic", "VerifyReport", "ProgramVerifyError",
           "PassVerifyError", "verify_program", "verify_before_run",
           "check_pass", "infer_block_types", "ERROR", "WARNING", "INFO"]

ERROR, WARNING, INFO = "error", "warning", "info"

# wildcard sentinel substituted for -1/None dims before the meta-tensor
# fallback: inferred dims divisible by it are wildcard-derived and are
# excluded from declared-vs-inferred comparison (a prime no real layer
# dim in the test zoo is a multiple of)
_WILDCARD = 193


class Diagnostic:
    """One typed finding. ``severity`` in {error, warning, info};
    ``code`` is a stable machine-readable id; ``callstack`` is the
    op's Python creation callstack when the program was built in this
    process (framework.Block.append_op captures it)."""

    __slots__ = ("severity", "code", "message", "block_idx", "op_idx",
                 "op_type", "var", "callstack")

    def __init__(self, severity, code, message, block_idx=0, op_idx=None,
                 op_type=None, var=None, callstack=None):
        self.severity = severity
        self.code = code
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.var = var
        self.callstack = callstack

    def format(self, with_callstack: bool = True) -> str:
        tag = {ERROR: "E", WARNING: "W", INFO: "I"}[self.severity]
        where = f"block {self.block_idx}"
        if self.op_idx is not None:
            where += f" op #{self.op_idx}"
        if self.op_type:
            where += f" [{self.op_type}]"
        line = f"[{tag}] {self.code}: {where}"
        if self.var:
            line += f" var '{self.var}'"
        line += f": {self.message}"
        if with_callstack and self.callstack:
            line += "".join(f"\n      created at {fr}"
                            for fr in self.callstack)
        return line

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return f"Diagnostic({self.format(with_callstack=False)})"


class VerifyReport:
    """verify_program's result: the diagnostics and the stats (wall ms,
    ops checked, how each op was checked)."""

    __slots__ = ("diagnostics", "ops_checked", "wall_ms",
                 "infer_rule_ops", "fallback_ops", "unverified_ops")

    def __init__(self):
        self.diagnostics: List[Diagnostic] = []
        self.ops_checked = 0
        self.wall_ms = 0.0
        self.infer_rule_ops = 0     # checked via a registered rule
        self.fallback_ops = 0       # checked on meta tensors
        self.unverified_ops = 0     # statically opaque / host / failed

    def add(self, *a, **kw):
        self.diagnostics.append(Diagnostic(*a, **kw))

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def counts(self) -> Dict[str, int]:
        out = {ERROR: 0, WARNING: 0, INFO: 0}
        for d in self.diagnostics:
            out[d.severity] += 1
        return out

    def summary(self) -> Dict[str, Any]:
        c = self.counts()
        return {"ops_checked": self.ops_checked,
                "wall_ms": round(self.wall_ms, 2),
                "errors": c[ERROR], "warnings": c[WARNING],
                "infos": c[INFO],
                "infer_rule_ops": self.infer_rule_ops,
                "fallback_ops": self.fallback_ops,
                "unverified_ops": self.unverified_ops}

    def format(self, min_severity: str = INFO) -> str:
        order = {ERROR: 0, WARNING: 1, INFO: 2}
        keep = [d for d in self.diagnostics
                if order[d.severity] <= order[min_severity]]
        lines = [d.format() for d in keep]
        c = self.counts()
        lines.append(f"-- verify: {self.ops_checked} ops checked in "
                     f"{self.wall_ms:.1f} ms; {c[ERROR]} error(s), "
                     f"{c[WARNING]} warning(s), {c[INFO]} info(s)")
        return "\n".join(lines)

    def raise_on_errors(self, context: str = ""):
        if self.errors:
            raise ProgramVerifyError(self.errors, context=context)
        return self


class ProgramVerifyError(ValueError):
    """Raised when error-severity diagnostics survive verification."""

    def __init__(self, diagnostics: Sequence[Diagnostic], context=""):
        self.diagnostics = list(diagnostics)
        head = (f"program verification failed ({context}): "
                if context else "program verification failed: ")
        body = "\n".join(d.format() for d in self.diagnostics[:20])
        more = len(self.diagnostics) - 20
        if more > 0:
            body += f"\n... and {more} more"
        super().__init__(head + f"{len(self.diagnostics)} error(s)\n"
                         + body)


class PassVerifyError(ProgramVerifyError):
    """A pipeline pass broke a program invariant; ``pass_name`` is the
    offending stage (verify-after-every-pass mode)."""

    def __init__(self, diagnostics, pass_name: str):
        self.pass_name = pass_name
        super().__init__(diagnostics,
                         context=f"after pass '{pass_name}'")


# ---------------------------------------------------------------------------
# shadow block: the view the registered infer rules run against
# ---------------------------------------------------------------------------

class _ShadowBlock:
    """Frontend-Block lookalike backed by VarDesc COPIES: the infer
    rules mutate shadow descs via ops.common.set_out_var, never the
    program's own. Lookup is recursive through the block parent chain,
    like the real Block."""

    def __init__(self, program_desc, block_idx: int):
        self._desc = program_desc
        self._idx = block_idx
        self._copies: Dict[str, VarDesc] = {}

    def _find_real(self, name: str) -> Optional[VarDesc]:
        idx = self._idx
        while idx is not None and idx >= 0:
            blk = self._desc.blocks[idx]
            if name in blk.vars:
                return blk.vars[name]
            idx = blk.parent_idx
        return None

    def _find_var_desc_recursive(self, name: str) -> Optional[VarDesc]:
        if name in self._copies:
            return self._copies[name]
        real = self._find_real(name)
        if real is None:
            return None
        cp = VarDesc(real.name, real.type, real.dtype, real.shape,
                     real.persistable, real.stop_gradient)
        self._copies[name] = cp
        return cp

    def has_var_recursive(self, name: str) -> bool:
        return self._find_var_desc_recursive(name) is not None

    def declared(self, name: str) -> Optional[VarDesc]:
        return self._find_real(name)

    def restore_declared(self, name: str):
        """Error recovery: after a mismatch diagnostic, downstream ops
        check against the DECLARED type, not the cascading inferred
        one."""
        real = self._find_real(name)
        cp = self._copies.get(name)
        if real is not None and cp is not None:
            if real.shape is not None:
                cp.shape = list(real.shape)
            if real.dtype is not None:
                cp.dtype = real.dtype


# ---------------------------------------------------------------------------
# type comparison helpers
# ---------------------------------------------------------------------------

def _norm_dtype(dt):
    """A declared or inferred dtype as the port's dtype name; an unknown
    one compares raw."""
    if dt is None:
        return None
    try:
        return dtype_to_str(convert_dtype(dt))
    except (ValueError, KeyError, TypeError):
        return str(dt)


def _dims_conflict(declared, inferred, fallback: bool = False) -> bool:
    """True when two shapes genuinely disagree. -1/None dims on either
    side are wildcards. With ``fallback=True`` (the inferred shape
    came from meta tensors with _WILDCARD-substituted dims),
    inferred dims divisible by the sentinel are wildcard-derived and
    skipped — on the registered-rule path no substitution happened, so
    a real dim that merely divides 193 must still compare."""
    if declared is None or inferred is None:
        return False
    da, db = list(declared), list(inferred)
    if len(da) != len(db):
        # rank-0 vs rank-1 single-element: the frontend stores both
        # spellings for scalars — not a defect
        if int(np.prod([abs(x) for x in da] or [1])) == 1 and \
                int(np.prod([abs(x) for x in db] or [1])) == 1:
            return False
        return True
    for x, y in zip(da, db):
        if x is None or y is None or x < 0 or y < 0:
            continue
        if fallback and y % _WILDCARD == 0:
            continue
        if x != y:
            return True
    return False


# ---------------------------------------------------------------------------
# abstract interpretation of one op
# ---------------------------------------------------------------------------

def _abstract_eval(op: OpDesc, shadow: _ShadowBlock) -> Optional[
        Dict[str, List[Tuple[tuple, Any]]]]:
    """Generic fallback: the op's registered emitter on meta tensors built
    from the shadow types (``is_test``, no generator). Returns {slot:
    [(shape, dtype), ...]} or None when the op cannot be evaluated so
    (missing input types, a host op, control flow, a random op, or an
    emitter that needs a generator, values or live state): unverifiable,
    never an error."""
    if not registry.has_op(op.type):
        return None
    info = registry.lookup(op.type)
    if info.emitter is None or info.is_host or info.needs_rng:
        return None
    if any(a in op.attrs for a in analyze.CONTROL_ATTRS):
        return None
    meta = torch.device("meta")
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if not n:
                vals.append(None)
                continue
            d = shadow._find_var_desc_recursive(n)
            if d is None or d.shape is None or d.dtype is None:
                return None
            shape = tuple(_WILDCARD if (s is None or s < 0) else int(s)
                          for s in d.shape)
            try:
                vals.append(torch.empty(shape, dtype=dtype_to_torch(d.dtype),
                                        device=meta))
            except (KeyError, ValueError, RuntimeError):
                return None
        ins[slot] = vals
    ctx = registry.EmitContext(meta, is_test=True)
    try:
        with torch.no_grad():
            outs = info.emitter(ctx, ins, dict(op.attrs))
    except Exception:  # noqa: BLE001 (unverifiable, not a defect)
        return None
    if not isinstance(outs, dict):
        return None
    result: Dict[str, List[Tuple[tuple, Any]]] = {}
    for slot, vals in outs.items():
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        result[slot] = [
            (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
            else None for v in vals]
    return result


def _generic_grad_infer(op: OpDesc, shadow: _ShadowBlock) -> Optional[
        Dict[str, List[Tuple[tuple, Any]]]]:
    """Structural rule for default-vjp ``*_grad`` twins: each output
    slot ``<s>@GRAD`` mirrors the forward input slot ``<s>`` name for
    name: a cotangent has its primal's shape and dtype. Costs nothing and
    covers the backward half of a training program (the port's own grad
    ops, ``conv2d_grad`` and ``flash_attention_grad``, included)."""
    if not op.type.endswith("_grad"):
        return None
    out: Dict[str, List[Tuple[tuple, Any]]] = {}
    for slot, names in op.outputs.items():
        if not slot.endswith(GRAD_SUFFIX):
            return None  # non-cotangent output: not a default twin
        fwd_slot = slot[: -len(GRAD_SUFFIX)]
        fwd_names = op.inputs.get(fwd_slot)
        if fwd_names is None or len(fwd_names) != len(names):
            return None
        row = []
        for n in fwd_names:
            d = shadow._find_var_desc_recursive(n) if n else None
            if d is None or d.shape is None:
                row.append(None)
            else:
                row.append((tuple(d.shape), d.dtype))
        out[slot] = row
    return out


def infer_block_types(program_desc, block_idx: int, report: VerifyReport,
                      check_shapes: bool = True,
                      frontend_block=None) -> _ShadowBlock:
    """Walk one block's OpDescs computing output types and comparing
    them against the declared VarDescs; diagnostics land in
    ``report``. Returns the shadow (final inferred types) so callers can
    annotate vars."""
    blk = program_desc.blocks[block_idx]
    shadow = _ShadowBlock(program_desc, block_idx)
    for i, op in enumerate(blk.ops):
        report.ops_checked += 1
        cs = getattr(op, "callstack", None)
        info = registry.lookup(op.type) if registry.has_op(op.type) \
            else None
        if not check_shapes:
            continue
        if info is not None and info.is_host:
            report.unverified_ops += 1
            continue
        if any(a in op.attrs for a in analyze.CONTROL_ATTRS):
            report.unverified_ops += 1
            continue
        if info is not None and getattr(info.infer_shape, "_opaque",
                                        False):
            # declared statically opaque (ops.common.opaque_infer):
            # nothing to check, and abstract eval would be wrong
            report.unverified_ops += 1
            continue
        inferred: Optional[Dict[str, List[Tuple[tuple, Any]]]] = None
        used_rule = False
        if info is not None and info.infer_shape is not None:
            # run the registered rule against the SHADOW, then read the
            # types it wrote there
            try:
                info.infer_shape(op, shadow)
                used_rule = True
                inferred = {}
                for slot, names in op.outputs.items():
                    row = []
                    for n in names:
                        cp = shadow._copies.get(n) if n else None
                        row.append((tuple(cp.shape), cp.dtype)
                                   if cp is not None
                                   and cp.shape is not None else None)
                    inferred[slot] = row
            except Exception as e:  # noqa: BLE001 — a crashing rule IS a finding
                report.add(WARNING, "infer_rule_crash",
                           f"registered infer_shape rule raised "
                           f"{type(e).__name__}: {e}",
                           block_idx=block_idx, op_idx=i,
                           op_type=op.type, callstack=cs)
                inferred = None
        from_fallback = False
        if inferred is None:
            inferred = _generic_grad_infer(op, shadow)
            used_rule = inferred is not None  # structural grad rule
        if inferred is not None and used_rule:
            report.infer_rule_ops += 1
        elif inferred is None:
            inferred = _abstract_eval(op, shadow)
            if inferred is not None:
                from_fallback = True
                report.fallback_ops += 1
            else:
                report.unverified_ops += 1
        if inferred is None:
            continue
        for slot, rows in inferred.items():
            names = op.outputs.get(slot, [])
            for n, row in zip(names, rows):
                if not n or row is None:
                    continue
                shape, dtype = row
                declared = shadow.declared(n)
                if declared is None:
                    continue
                if declared.shape is not None and _dims_conflict(
                        declared.shape, shape,
                        fallback=from_fallback):
                    report.add(
                        ERROR, "shape_mismatch",
                        f"declared shape {list(declared.shape)} but the "
                        f"op's infer rule/emitter produces "
                        f"{list(shape)} (inputs: "
                        f"{_fmt_inputs(op, shadow)})",
                        block_idx=block_idx, op_idx=i, op_type=op.type,
                        var=n, callstack=cs)
                    shadow.restore_declared(n)
                dd, di = _norm_dtype(declared.dtype), _norm_dtype(dtype)
                if dd is not None and di is not None and dd != di:
                    report.add(
                        ERROR, "dtype_mismatch",
                        f"declared dtype {dd} but the op's infer "
                        f"rule/emitter produces {di}",
                        block_idx=block_idx, op_idx=i, op_type=op.type,
                        var=n, callstack=cs)
                    shadow.restore_declared(n)
                cp = shadow._copies.get(n)
                if cp is None:
                    cp = shadow._find_var_desc_recursive(n)
                if cp is not None and cp.shape is None \
                        and shape is not None:
                    # undeclared temp: carry the inferred type forward
                    cp.shape = [int(s) for s in shape]
                    if dtype is not None and cp.dtype is None:
                        cp.dtype = _to_datatype(dtype)
    return shadow


def _to_datatype(dtype):
    try:
        return convert_dtype(dtype)
    except (ValueError, KeyError, TypeError):
        return None


def _fmt_inputs(op: OpDesc, shadow: _ShadowBlock) -> str:
    parts = []
    for slot, names in op.inputs.items():
        for n in names:
            if not n:
                continue
            d = shadow._find_var_desc_recursive(n)
            parts.append(f"{slot}={n}:"
                         f"{list(d.shape) if d is not None and d.shape is not None else '?'}")
    return ", ".join(parts) or "none"


# ---------------------------------------------------------------------------
# the checker battery
# ---------------------------------------------------------------------------

def _cs(op):
    return getattr(op, "callstack", None)


def _check_defs(blk, block_idx, pdu, report, feed_names, persistable):
    """Undefined vars, never-written inputs, use-before-def of local
    temporaries, and double-writer hazards."""
    du = pdu.def_use(block_idx)
    written: Set[str] = set()
    outer_ok: Set[str] = set()  # resolvable through the parent chain
    for i, op in enumerate(blk.ops):
        for n in op.input_arg_names():
            if not n or n in written or n in outer_ok:
                continue
            # resolve the var desc through the nesting chain
            idx = block_idx
            found = None
            while idx is not None and idx >= 0:
                b = pdu.desc.blocks[idx]
                if n in b.vars:
                    found = (idx, b.vars[n])
                    break
                idx = b.parent_idx
            if found is None:
                report.add(ERROR, "undefined_var",
                           "input has no VarDesc in this block or any "
                           "ancestor — the program reads a variable "
                           "that does not exist",
                           block_idx=block_idx, op_idx=i,
                           op_type=op.type, var=n, callstack=_cs(op))
                outer_ok.add(n)  # report once
                continue
            owner_idx, vd = found
            if owner_idx != block_idx:
                outer_ok.add(n)  # outer-block value: defined there
                continue
            w = du.write_positions(n)
            if w and w[0] > i and not vd.persistable:
                report.add(ERROR, "read_before_write",
                           f"read at op #{i} but the first write is at "
                           f"op #{w[0]} — a non-persistable temporary "
                           "read before it is defined",
                           block_idx=block_idx, op_idx=i,
                           op_type=op.type, var=n, callstack=_cs(op))
            elif not w and not vd.persistable \
                    and feed_names is not None \
                    and n not in feed_names:
                report.add(ERROR, "never_written_input",
                           "no op writes this non-persistable var and "
                           "it is not in the declared feed list — at "
                           "run time the executor will raise 'neither "
                           "fed nor initialized'",
                           block_idx=block_idx, op_idx=i,
                           op_type=op.type, var=n, callstack=_cs(op))
            outer_ok.add(n)
        for n in op.output_arg_names():
            if n:
                written.add(n)
    # double-writer hazards: a non-persistable name written twice where
    # the later writer does NOT read it (blind rebind). Accumulation
    # rebinds (sum reading its own contributions, in-place updates
    # reading the old value) are the legitimate sequential idiom.
    for n, w in du.writers.items():
        if len(w) < 2 or n in persistable:
            continue
        for j in w[1:]:
            op = blk.ops[j] if j < len(blk.ops) else None
            if op is None:
                continue
            reads_self = n in op.input_arg_names() or any(
                x.split("@RENAME@")[0] == n
                for x in op.input_arg_names() if x)
            if not reads_self:
                report.add(
                    WARNING, "double_writer",
                    f"written by ops {w} but the write at #{j} does "
                    "not read the prior value — the first write is "
                    "dead or the ops are mis-ordered (passes treat "
                    "multi-writer vars conservatively)",
                    block_idx=block_idx, op_idx=j, op_type=op.type,
                    var=n, callstack=_cs(op))
                break


def _check_donation(blk, block_idx, report):
    """Donation safety: the executor updates persistable state in place
    (the scope's tensors are a captured graph's). An OPTIMIZE-role op
    that rebinds a var it reads (the in-place param update) overwrites
    that buffer; a LATER non-optimizer read of the same name sees the
    post-update value: almost always a mis-ordered program or a pass
    that moved a read across the update."""
    donated: Dict[str, int] = {}
    for i, op in enumerate(blk.ops):
        role = int(op.attrs.get(OP_ROLE_ATTR_NAME, 0) or 0)
        # LRSCHED in-place writes (the step-counter increment) are
        # DESIGNED to be read post-update by the forward-role schedule
        # math — only OPTIMIZE-bit rebinds (param/state updates) donate
        is_opt = bool(role & (int(OpRole.OPTIMIZE) | int(OpRole.LRSCHED)))
        if not is_opt:
            for n in op.input_arg_names():
                if n in donated:
                    report.add(
                        ERROR, "donated_reread",
                        f"rewritten in place by OPTIMIZE-role op "
                        f"#{donated[n]} and re-read here by a "
                        f"non-optimizer op — the read observes the "
                        "post-update (donated) buffer; move the read "
                        "before the update or fetch the pre-update "
                        "value explicitly",
                        block_idx=block_idx, op_idx=i, op_type=op.type,
                        var=n, callstack=_cs(op))
                    del donated[n]
        if role & int(OpRole.OPTIMIZE):
            ins = set(op.input_arg_names())
            for n in op.output_arg_names():
                if n and n in ins:
                    donated[n] = i


def _check_rng(blk, block_idx, pdu, report, fetch_names):
    """RNG hygiene: a random op whose outputs nothing reads (and that is
    neither fetched nor persistable) still advances the generator: DCE
    must keep it (pipeline contract), so flag it to the author."""
    du = pdu.def_use(block_idx)
    for i, op in enumerate(blk.ops):
        if not (registry.has_op(op.type)
                and registry.lookup(op.type).needs_rng):
            continue
        outs = [n for n in op.output_arg_names() if n]
        live = False
        for n in outs:
            vd = blk.vars.get(n)
            if du.readers_after(n, i) or (vd is not None
                                          and vd.persistable) \
                    or (fetch_names and n in fetch_names):
                live = True
                break
        if outs and not live:
            report.add(
                WARNING, "dead_rng_op",
                "no op reads this RNG op's outputs, but it still "
                "advances the run's generator (DCE keeps it to "
                "preserve downstream draws) — delete it from the "
                "program if the randomness is unwanted",
                block_idx=block_idx, op_idx=i, op_type=op.type,
                var=outs[0], callstack=_cs(op))


def _check_grad_twins(blk, block_idx, report):
    """Grad-twin / op_role_var consistency."""
    for i, op in enumerate(blk.ops):
        pairs = op.attrs.get(OP_ROLE_VAR_ATTR_NAME) or []
        if pairs:
            if len(pairs) % 2:
                report.add(ERROR, "op_role_var_arity",
                           f"op_role_var has odd length {len(pairs)}; "
                           "it must be [param, grad] pairs",
                           block_idx=block_idx, op_idx=i,
                           op_type=op.type, callstack=_cs(op))
            else:
                outs = set(op.output_arg_names())
                for p, g in zip(pairs[0::2], pairs[1::2]):
                    if g not in outs:
                        report.add(
                            ERROR, "op_role_var_not_produced",
                            f"op_role_var names grad '{g}' for param "
                            f"'{p}' but this op does not write it — "
                            "collective insertion and the fused "
                            "optimizer group on these pairs",
                            block_idx=block_idx, op_idx=i,
                            op_type=op.type, var=g, callstack=_cs(op))
                    base = g.split("@RENAME@")[0]
                    if not base.endswith(GRAD_SUFFIX) \
                            or base[: -len(GRAD_SUFFIX)] != p:
                        report.add(
                            WARNING, "op_role_var_naming",
                            f"grad '{g}' does not follow "
                            f"'{p}{GRAD_SUFFIX}' naming — downstream "
                            "planners key grads to params by suffix",
                            block_idx=block_idx, op_idx=i,
                            op_type=op.type, var=g, callstack=_cs(op))
        fwd = op.attrs.get("__fwd_type__")
        if fwd is not None and not registry.has_op(fwd):
            report.add(ERROR, "grad_twin_unregistered",
                       f"grad op references forward type '{fwd}' which "
                       "is not registered — the generic vjp emitter "
                       "cannot run it",
                       block_idx=block_idx, op_idx=i, op_type=op.type,
                       callstack=_cs(op))


def _check_retrace_risk(blk, block_idx, pdu, report):
    """Retrace-risk lints (a shape that changes every step makes a new
    plan each run): concat-grow KV caches, and host-op blocks."""
    du = pdu.def_use(block_idx)
    for i, op in enumerate(blk.ops):
        if op.type == "concat":
            ins = [n for n in op.input_arg_names() if n]
            out = next((n for n in op.output_arg_names() if n), None)
            grow = out in ins if out else False
            if not grow and out is not None:
                # concat result assigned back onto one of its inputs
                # (cache = assign(concat(cache, new))): same idiom
                for j in du.readers_after(out, i):
                    nxt = blk.ops[j]
                    if nxt.type == "assign" and any(
                            o in ins for o in nxt.output_arg_names()):
                        grow = True
                        break
            if grow:
                report.add(
                    WARNING, "retrace_concat_grow",
                    "concat grows a tensor back into one of its own "
                    "inputs — a growing cache changes shape every "
                    "step, forcing a new plan and CUDA graph per decoded "
                    "token; use "
                    "the fixed-capacity kv_cache_write op (dynamic "
                    "update into a preallocated [.., cap, ..] cache) "
                    "instead",
                    block_idx=block_idx, op_idx=i, op_type=op.type,
                    var=(out or (ins[0] if ins else None)),
                    callstack=_cs(op))
        if registry.has_op(op.type) and registry.lookup(op.type).is_host:
            report.add(
                INFO, "host_op_splits_block",
                "host op splits the block into separate device "
                "segments: run(iterations=K) falls back to sequential "
                "single-step runs, a CUDA graph ends here and values "
                "round-trip through host memory at this boundary",
                block_idx=block_idx, op_idx=i, op_type=op.type,
                callstack=_cs(op))


def _check_registered(blk, block_idx, report):
    for i, op in enumerate(blk.ops):
        if op.type in ("feed", "fetch") or registry.has_op(op.type):
            continue
        if op.type.endswith("_grad") \
                and registry.has_op(op.type[: -len("_grad")]):
            continue  # resolves through the generic vjp emitter
        report.add(ERROR, "unregistered_op",
                   "op type is not in the registry and has no grad "
                   "resolution — lowering will fail",
                   block_idx=block_idx, op_idx=i, op_type=op.type,
                   callstack=_cs(op))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def verify_program(program, feed_names=None, fetch_names=None,
                   check_shapes: bool = True) -> VerifyReport:
    """Run the full checker battery + abstract interpreter over every
    block of ``program`` (a frontend Program or a raw ProgramDesc).
    ``feed_names`` enables the never-written-input check (None skips
    it: a bare Program cannot know its feed set). Returns a
    :class:`VerifyReport`; call ``.raise_on_errors()`` to turn
    error-severity findings into a :class:`ProgramVerifyError`."""
    t0 = time.perf_counter()
    desc = getattr(program, "desc", program)
    report = VerifyReport()
    pdu = analyze.ProgramDefUse(desc)
    feed_set = set(feed_names) if feed_names is not None else None
    fetch_set = set(fetch_names or ())
    persistable = {n for b in desc.blocks
                   for n, v in b.vars.items() if v.persistable}
    for blk in desc.blocks:
        idx = blk.idx
        _check_registered(blk, idx, report)
        _check_defs(blk, idx, pdu, report, feed_set, persistable)
        _check_donation(blk, idx, report)
        _check_rng(blk, idx, pdu, report, fetch_set)
        _check_grad_twins(blk, idx, report)
        _check_retrace_risk(blk, idx, pdu, report)
        infer_block_types(desc, idx, report, check_shapes=check_shapes)
    report.wall_ms = (time.perf_counter() - t0) * 1e3
    return report


def verify_before_run(program, feed_names=None, fetch_names=None):
    """Executor hook (``FLAGS.verify_passes`` /
    ``build_strategy.verify_passes``): verify the program before its
    first preparation, memoized per program version so later runs pay a
    dict lookup. Raises ProgramVerifyError on error-severity findings;
    the report lands in the monitor (``verify_seconds``,
    ``verify_findings{severity=}``, ``verify_ops_checked_total``) either
    way."""
    from .. import monitor as _monitor

    memo = program.__dict__.setdefault("_verify_memo", {})
    version = getattr(program, "_version", 0)
    cached = memo.get(version)
    if cached is not None:
        return cached
    report = verify_program(program, feed_names=feed_names,
                            fetch_names=fetch_names)
    if _monitor.enabled():
        _monitor.timer("verify_seconds").observe(report.wall_ms / 1e3)
        c = report.counts()
        _monitor.gauge("verify_findings", {"severity": ERROR}).set(
            c[ERROR])
        _monitor.gauge("verify_findings", {"severity": WARNING}).set(
            c[WARNING])
        _monitor.counter("verify_ops_checked_total").inc(
            report.ops_checked)
    report.raise_on_errors(context=f"program v{version}")
    memo[version] = report
    return report


# ---------------------------------------------------------------------------
# pass-boundary invariants (verify-after-every-pass mode)
# ---------------------------------------------------------------------------

def check_pass(before: Sequence[OpDesc], after: Sequence[OpDesc],
               pass_name: str, needed: Set[str],
               block=None) -> None:
    """Structural invariants every ir/pipeline.py pass must preserve,
    checked at the pass boundary so a broken rewrite fails naming the
    pass, not at the op that later breaks. O(ops) per pass; runs inside
    the executor's per-version pipeline memo, so later runs pay nothing.

    Invariants (the pipeline's documented contract):
      - every ``needed`` name written before the pass is still written
        (fetches / persistable state / downstream reads stay bound)
      - the external-read set does not grow (no new undefined inputs)
      - the random-op sequence is unchanged (the generator must advance
        exactly as the unoptimized program's would)
      - host ops survive in order (eager host effects are not
        reordered or dropped)
      - no new multi-writer vars (passes never un-SSA a single-writer
        name)
    """
    diags: List[Diagnostic] = []
    du_b = analyze.DefUse(before)
    du_a = analyze.DefUse(after)

    written_b = set(du_b.writers)
    written_a = set(du_a.writers)
    for n in sorted((needed & written_b) - written_a):
        diags.append(Diagnostic(
            ERROR, "pass_dropped_needed",
            f"pass removed the only writer of needed var '{n}' "
            "(fetch / persistable state / downstream segment read)",
            var=n))

    # reads that resolve OUTSIDE the list grew: either the pass reads a
    # var the segment never receives, or it dropped/reordered a writer
    # while keeping readers (the relu-eaten-but-still-read shape)
    new_ext = du_a.external_reads() - du_b.external_reads()
    for n in sorted(new_ext):
        readers = du_a.read_positions(n)
        op = after[readers[0]] if readers else None
        diags.append(Diagnostic(
            ERROR, "pass_new_undefined_read",
            "read now resolves outside the segment (it did not before "
            "the pass): the pass reads a var the segment never "
            "receives, or removed/reordered the var's writer while "
            "keeping readers",
            op_idx=(readers[0] if readers else None),
            op_type=(op.type if op is not None else None),
            var=n, callstack=_cs(op) if op is not None else None))

    rng_b, rng_a = analyze.rng_sequence(before), analyze.rng_sequence(after)
    if rng_b != rng_a:
        diags.append(Diagnostic(
            ERROR, "pass_rng_stream_changed",
            f"RNG-consuming op sequence changed {rng_b} -> {rng_a}: "
            "every downstream random draw shifts (RNG ops must never "
            "be CSE'd, removed, or reordered)"))

    def host_seq(ops):
        return [op.type for op in ops
                if registry.has_op(op.type)
                and registry.lookup(op.type).is_host]

    if host_seq(before) != host_seq(after):
        diags.append(Diagnostic(
            ERROR, "pass_host_ops_changed",
            f"host-op sequence changed {host_seq(before)} -> "
            f"{host_seq(after)}: passes must leave host ops alone"))

    persistable = set()
    if block is not None:
        vars_tab = getattr(block, "vars", {})
        for n, v in vars_tab.items():
            d = getattr(v, "desc", v)
            if getattr(d, "persistable", False):
                persistable.add(n)
    wc_b = du_b.writer_counts()
    for n, ws in du_a.writers.items():
        if len(ws) > 1 and wc_b.get(n, 0) <= 1 and n not in persistable:
            op = after[ws[1]]
            diags.append(Diagnostic(
                ERROR, "pass_new_double_writer",
                f"pass turned single-writer var into a {len(ws)}-way "
                "multi-writer (write positions "
                f"{list(ws)})", op_idx=ws[1], op_type=op.type, var=n,
                callstack=_cs(op)))

    if diags:
        raise PassVerifyError(diags, pass_name)

"""Control-flow layers (reference python/paddle/fluid/layers/
control_flow.py): ``While`` and its counter ops, ``IfElse`` and
``Switch``, the dense tensor-array ops, ``StaticRNN`` and ``DynamicRNN``
(the ``recurrent`` op), the LoD helpers (``is_empty``, ``lod_rank_table``,
``reorder_lod_tensor_by_rank``) and ``Print``.

A ``While`` body is a sub-block; the ``while`` op runs it
(ops/kernels_control.py). A loop that matches the bounded-counter pattern
gets a static trip bound at build time (``__inferred_trip_bound__``), so
the port runs it as a fixed number of masked trips that can be captured
in a CUDA graph.
"""

from __future__ import annotations

import math
from typing import List

from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper

__all__ = ["While", "IfElse", "increment", "array_write", "array_read",
           "less_than", "equal", "Switch", "StaticRNN", "DynamicRNN",
           "Print", "create_array", "array_length", "is_empty",
           "lod_rank_table", "reorder_lod_tensor_by_rank"]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="increment", inputs={"X": x},
                     outputs={"Out": out}, attrs={"step": float(value)})
    return out


def less_than(x, y, force_cpu=None, cond=None):
    """x < y into ``cond`` (a new bool variable when None): a loop body
    recomputes its While's condition with ``cond=``."""
    helper = LayerHelper("less_than")
    cond = cond or helper.create_variable_for_type_inference("bool")
    helper.append_op(type="less_than", inputs={"X": x, "Y": y},
                     outputs={"Out": cond})
    return cond


def equal(x, y, cond=None):
    """x == y into ``cond`` (a new bool variable when None)."""
    helper = LayerHelper("equal")
    cond = cond or helper.create_variable_for_type_inference("bool")
    helper.append_op(type="equal", inputs={"X": x, "Y": y},
                     outputs={"Out": cond})
    return cond


class While:
    """``with While(cond).block(): ...`` builds the loop body; variables
    of the enclosing blocks that the body reads or writes are carried.
    ``max_trip_count=N`` bounds the trip count (an overestimate is safe:
    trips past the condition are masked)."""

    def __init__(self, cond: Variable, is_test=False, name=None,
                 max_trip_count=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.is_test = is_test
        self.max_trip_count = max_trip_count

    def block(self):
        return _WhileBlockGuard(self)


def _static_trip_bound(parent_block, sub_block, cond_name):
    """An upper bound on a While's trip count read off the program, or
    None: ``cond = less_than(i, n)`` recomputed in the body, ``i`` and
    ``n`` made by fill_constant in the parent, ``n`` not written in the
    body, and ``i``'s only body writer one positive-step ``increment``
    before the comparison. Then the bound is ceil((n - start) / step)."""
    def producer(block, name):
        for op in reversed(block.ops):
            if name in op.output_arg_names:
                return op
        return None

    cmp_op = producer(sub_block, cond_name)
    if cmp_op is None or cmp_op.type != "less_than":
        return None
    xn = cmp_op.desc.inputs["X"][0]
    yn = cmp_op.desc.inputs["Y"][0]

    def const_value(name):
        p = producer(parent_block, name)
        if p is not None and p.type == "fill_constant":
            try:
                return float(p.attrs.get("value", 0.0))
            except (TypeError, ValueError):
                return None
        return None

    start, limit = const_value(xn), const_value(yn)
    if start is None or limit is None:
        return None
    if any(yn in op.output_arg_names for op in sub_block.ops):
        return None
    inc_idx, step = None, None
    for k, op in enumerate(sub_block.ops):
        if xn not in op.output_arg_names:
            continue
        if inc_idx is not None or op.type != "increment":
            return None
        inc_idx = k
        try:
            step = float(op.attrs.get("step", 1.0))
        except (TypeError, ValueError):
            return None
    cmp_idx = max(k for k, op in enumerate(sub_block.ops)
                  if cond_name in op.output_arg_names)
    if inc_idx is None or step is None or step <= 0 or inc_idx > cmp_idx:
        return None
    trips = int(math.ceil((limit - start) / step))
    return trips if trips > 0 else None


class _WhileBlockGuard:
    def __init__(self, while_op: While):
        self.while_op = while_op
        self.main_program = default_main_program()

    def __enter__(self):
        self.sub_block = self.main_program._create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        main = self.main_program
        sub_block = self.sub_block
        main._rollback()
        parent_block = main.current_block()

        # carried: the enclosing blocks' vars the body reads or writes
        carried: List[str] = []
        seen = set()
        for op in sub_block.ops:
            for name in (op.input_arg_names + op.output_arg_names):
                if name in seen:
                    continue
                seen.add(name)
                if parent_block.has_var_recursive(name):
                    carried.append(name)
        cond_name = self.while_op.cond_var.name
        if cond_name in carried:
            carried.remove(cond_name)
        # the loop's inputs snapshot under names of their own (the op
        # rebinds the carried names)
        from ..utils import unique_name
        in_names = []
        for name in carried:
            v = parent_block.var(name)
            saved = parent_block.create_var(
                name=unique_name.generate(f"{name}@while_in"),
                dtype=v.dtype,
                shape=v.desc.shape, stop_gradient=v.desc.stop_gradient)
            parent_block.append_op(type="assign", inputs={"X": [name]},
                                   outputs={"Out": [saved.name]})
            in_names.append(saved.name)
        max_trip = int(self.while_op.max_trip_count or 0)
        inferred = 0
        if max_trip <= 0:
            bound = _static_trip_bound(parent_block, sub_block, cond_name)
            if bound is not None:
                inferred = int(bound)
        parent_block.append_op(
            type="while",
            inputs={"X": in_names, "Condition": [cond_name]},
            outputs={"Out": carried},
            attrs={"sub_block": sub_block.idx,
                   "__x_names__": carried,
                   "__cond_name__": cond_name,
                   "max_trip_count": max_trip,
                   "__inferred_trip_bound__": inferred,
                   "is_test": self.while_op.is_test})
        return True


class IfElse:
    """Per-row branching: ``cond`` is an [N, 1] bool tensor; both branch
    blocks compute over the whole batch (their ops go into the parent
    block) and one ``if_else`` op merges each pair of outputs row by row.
    ``input(x)`` returns x whole, not Fluid's gathered row subset: the
    results are the same whenever the branch ops treat rows independently,
    Fluid's own use. Differentiable: each row's gradient goes to the
    branch that made it.

        ie = layers.IfElse(cond)
        with ie.true_block():
            ie.output(f(ie.input(x)))
        with ie.false_block():
            ie.output(g(ie.input(x)))
        merged, = ie()
    """

    OUT_IF_ELSE_BLOCKS = True

    def __init__(self, cond: Variable, name=None):
        self.helper = LayerHelper("if_else", name=name)
        self.cond = cond
        self.true_outs: List[Variable] = []
        self.false_outs: List[Variable] = []
        self._cur = None
        self._merged = None

    def true_block(self):
        return _IfElseBranchGuard(self, True)

    def false_block(self):
        return _IfElseBranchGuard(self, False)

    def input(self, x):
        if self._cur is None:
            raise RuntimeError("IfElse.input must be called inside "
                               "true_block()/false_block()")
        return x

    def output(self, *outs):
        if self._cur is None:
            raise RuntimeError("IfElse.output must be called inside "
                               "true_block()/false_block()")
        (self.true_outs if self._cur else self.false_outs).extend(outs)

    def __call__(self):
        if self._merged is not None:
            return self._merged
        if len(self.true_outs) != len(self.false_outs):
            raise ValueError(
                f"IfElse branches produced {len(self.true_outs)} vs "
                f"{len(self.false_outs)} outputs; they must pair up")
        if not self.true_outs:
            raise ValueError("IfElse has no outputs")
        merged = [self.helper.create_variable_for_type_inference(t.dtype)
                  for t in self.true_outs]
        self.helper.append_op(
            type="if_else",
            inputs={"Cond": self.cond, "TrueOut": self.true_outs,
                    "FalseOut": self.false_outs},
            outputs={"Out": merged})
        self._merged = merged
        return merged


class _IfElseBranchGuard:
    def __init__(self, ie: IfElse, is_true: bool):
        self.ie = ie
        self.is_true = is_true

    def __enter__(self):
        self.ie._cur = self.is_true
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.ie._cur = None
        return False


class Switch:
    """Exactly the FIRST true case's writes take effect:

        with layers.Switch() as switch:
            with switch.case(cond1):
                layers.assign(v1, out)
            with switch.case(cond2):
                layers.assign(v2, out)
            with switch.default():
                layers.assign(v3, out)

    Every case's ops run, but each case writes to temporaries of its own
    (``<name>@switch_case<i>``); on exit one ``switch_merge`` op per
    variable that existed before the switch selects the first true
    case's value (the default's, else the variable's own, as the
    fallback). The same results as Fluid's conditional blocks whenever the
    case bodies are side-effect-free compute, Fluid's own use (learning
    rate schedules writing through ``assign``). A variable created inside
    a case has no value after the switch: reading or fetching it raises."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.block = self.helper.block
        # [(cond variable or None, {original name: case name})]
        self._cases = []
        self._pre_vars = None

    def __enter__(self):
        self._pre_vars = set(self.block.vars)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self._merge()
        return False

    def case(self, condition):
        if self._pre_vars is None:
            raise RuntimeError("use `with Switch() as switch:`")
        return _SwitchCaseGuard(self, condition)

    def default(self):
        if self._pre_vars is None:
            raise RuntimeError("use `with Switch() as switch:`")
        return _SwitchCaseGuard(self, None)

    def _is_pre_existing(self, name):
        # alive before the switch: in this block's snapshot, or found in an
        # enclosing block (a Switch inside a loop body writing outer state)
        if name in self._pre_vars:
            return True
        return (name not in self.block.vars
                and self.block.has_var_recursive(name))

    def _capture(self, cond, start_idx):
        """Redirect the writes of the case's ops into per-case names."""
        idx = len(self._cases)
        mapping = {}
        for op in self.block.desc.ops[start_idx:]:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [mapping.get(n, n) for n in names]
            for slot, names in op.outputs.items():
                renamed = []
                for n in names:
                    if not n:
                        renamed.append(n)
                        continue
                    if n not in mapping:
                        tmp = f"{n}@switch_case{idx}"
                        src = (self.block.vars.get(n)
                               or (self.block.var(n)
                                   if self.block.has_var_recursive(n)
                                   else None))
                        self.block.create_var(
                            name=tmp,
                            dtype=src.dtype if src is not None
                            else "float32",
                            stop_gradient=True)
                        mapping[n] = tmp
                        # a variable created in this case has no merged
                        # value: mark it, so that a later read raises
                        if (not self._is_pre_existing(n)
                                and src is not None):
                            src._switch_case_local = True
                    renamed.append(mapping[n])
                op.outputs[slot] = renamed
        self._cases.append((cond, mapping))

    def _merge(self):
        written = []
        for _, mapping in self._cases:
            for n in mapping:
                if self._is_pre_existing(n) and n not in written:
                    written.append(n)
        for name in written:
            conds, vals = [], []
            default_val = name  # no default: the value before the switch
            for cond, mapping in self._cases:
                if cond is None:
                    if name in mapping:
                        default_val = mapping[name]
                    continue
                # every case takes part: a true case that did not write
                # ``name`` still stops the later ones, with the value
                # from before the switch
                conds.append(cond)
                vals.append(mapping.get(name, name))
            self.block.append_op(
                type="switch_merge",
                inputs={"Conds": conds, "X": vals,
                        "Default": [default_val]},
                outputs={"Out": [name]})


class _SwitchCaseGuard:
    def __init__(self, switch: Switch, cond):
        self._switch = switch
        self._cond = cond

    def __enter__(self):
        self._start = len(self._switch.block.desc.ops)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is None:
            self._switch._capture(self._cond, self._start)
        return False


def array_write(x, i, array=None):
    """Array[i] = x on a dense [max_len, ...] array made beforehand (a
    fill_constant of the full shape)."""
    helper = LayerHelper("array_write")
    if array is None:
        raise ValueError("array_write requires a pre-created array "
                         "(create via layers.zeros with max_len leading "
                         "dim) under static shapes")
    out = array
    helper.append_op(type="array_write",
                     inputs={"X": x, "I": i, "Array": array},
                     outputs={"Out": out})
    return out


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="array_read", inputs={"Array": array, "I": i},
                     outputs={"Out": out})
    return out


class StaticRNN:
    """layers/control_flow.py StaticRNN: a per-timestep sub-block run by
    the ``recurrent`` op over [B, T, ...] inputs, one step per t of a
    static T (ops/kernels_control.py), forward and backward.

        rnn = StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)          # x: [B, T, D] -> xt [B, D]
            h = rnn.memory(init=h0)         # carried state
            nh = ...layers(xt, h)...
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out = rnn()                          # [B, T, H]
    """

    def __init__(self, name=None, length=None, is_reverse=False):
        self.helper = LayerHelper("recurrent", name=name)
        self.seq_pairs = []      # (outer var, step var)
        self.mem_pairs = []      # (init var, pre var, post var)
        self.outputs = []        # step-local out vars
        self.length = length
        self.is_reverse = is_reverse
        self.sub_block = None
        self._out_vars = None

    def step(self):
        return _StaticRNNBlockGuard(self)

    def _in_step(self):
        if self.sub_block is None:
            raise RuntimeError("call inside `with rnn.step():`")

    def step_input(self, x):
        self._in_step()
        step_var = self.sub_block.create_var(
            name=f"{x.name}@rnn_step", dtype=x.dtype,
            shape=[x.shape[0]] + list(x.shape[2:]), stop_gradient=False)
        self.seq_pairs.append((x, step_var))
        return step_var

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, dtype="float32"):
        self._in_step()
        if init is None:
            if shape is None:
                raise ValueError(
                    "StaticRNN.memory needs either `init` or `shape` "
                    "(+ optional batch_ref for the batch dim)")
            from . import tensor as tensor_layers
            prog = default_main_program()
            cur_idx = prog.current_block_idx
            # the init lives in the enclosing block, not the step block
            prog.current_block_idx = self.sub_block.parent_idx
            try:
                if batch_ref is not None:
                    init = tensor_layers.fill_constant_batch_size_like(
                        input=batch_ref, shape=list(shape), dtype=dtype,
                        value=init_value)
                else:
                    if any(s is None or s < 0 for s in shape):
                        raise ValueError(
                            "StaticRNN.memory with a -1 dim requires "
                            "batch_ref to supply the batch size")
                    init = tensor_layers.fill_constant(
                        shape=list(shape), dtype=dtype, value=init_value)
            finally:
                prog.current_block_idx = cur_idx
        pre = self.sub_block.create_var(
            name=f"{init.name}@rnn_pre", dtype=init.dtype,
            shape=list(init.shape), stop_gradient=False)
        self.mem_pairs.append([init, pre, None])
        return pre

    def update_memory(self, pre, post):
        self._in_step()
        for rec in self.mem_pairs:
            if rec[1] is pre or rec[1].name == pre.name:
                rec[2] = post
                return
        raise ValueError(f"{pre.name} is not a memory of this RNN")

    def step_output(self, o):
        self._in_step()
        self.outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _finalize(self, parent_block):
        for rec in self.mem_pairs:
            if rec[2] is None:
                raise ValueError(
                    f"memory {rec[1].name} was never update_memory()-ed")
        # outer vars the body reads (the weights)
        internal = {v.name for _, v in self.seq_pairs}
        internal |= {r[1].name for r in self.mem_pairs}
        param_names = []
        produced = set()
        for op in self.sub_block.ops:
            for name in op.input_arg_names:
                if (name not in internal and name not in produced
                        and name not in param_names
                        and parent_block.has_var_recursive(name)
                        and not self.sub_block.has_var(name)):
                    param_names.append(name)
            produced.update(op.output_arg_names)

        out_vars = []
        final_vars = []
        for o in self.outputs:
            ov = parent_block.create_var(
                name=f"{o.name}@rnn_out",
                dtype=o.dtype, stop_gradient=False)
            out_vars.append(ov)
        for rec in self.mem_pairs:
            fv = parent_block.create_var(
                name=f"{rec[1].name}@rnn_final", dtype=rec[0].dtype,
                shape=list(rec[0].shape), stop_gradient=False)
            final_vars.append(fv)

        inputs = {"X": [p[0] for p in self.seq_pairs],
                  "H0": [r[0] for r in self.mem_pairs],
                  "Params": param_names}
        if self.length is not None:
            inputs["Length"] = self.length
        parent_block.append_op(
            type="recurrent", inputs=inputs,
            outputs={"Out": out_vars, "HFinal": final_vars},
            attrs={"sub_block": self.sub_block.idx,
                   "__seq_names__": [v.name for _, v in self.seq_pairs],
                   "__state_pre__": [r[1].name for r in self.mem_pairs],
                   "__state_post__": [r[2].name for r in self.mem_pairs],
                   "__out_names__": [o.name for o in self.outputs],
                   "__param_names__": param_names,
                   "is_reverse": self.is_reverse})
        self._out_vars = out_vars
        self._final_vars = final_vars

    def __call__(self, *args, **kwargs):
        if self._out_vars is None:
            raise RuntimeError("StaticRNN not finalized (exit the step "
                               "block first)")
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars

    def final_states(self):
        return (self._final_vars[0] if len(self._final_vars) == 1
                else self._final_vars)


class _StaticRNNBlockGuard:
    def __init__(self, rnn: StaticRNN):
        self.rnn = rnn
        self.main_program = default_main_program()

    def __enter__(self):
        self.rnn.sub_block = self.main_program._create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.main_program._rollback()
        self.rnn._finalize(self.main_program.current_block())
        return True


class DynamicRNN(StaticRNN):
    """layers/control_flow.py DynamicRNN: the StaticRNN loop with a
    ``length`` [B]: past each row's length its state freezes and its step
    outputs are zero (the LoD-driven loop on the padded convention)."""

    def __init__(self, length, name=None, is_reverse=False):
        super().__init__(name=name, length=length, is_reverse=is_reverse)

    def block(self):
        return self.step()

    def static_input(self, x):
        return x


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """control_flow.py Print (print_op.cc): a host op that prints
    ``input`` when the program runs; the input flows through unchanged.
    A block holding it runs in device segments split at the op."""
    helper = LayerHelper("print")
    helper.append_op(
        type="print", inputs={"In": input}, outputs={},
        attrs={"first_n": first_n, "message": message or "",
               "summarize": summarize,
               "print_tensor_name": print_tensor_name,
               "print_tensor_type": print_tensor_type,
               "print_tensor_shape": print_tensor_shape,
               "print_phase": print_phase})
    return input


def create_array(dtype, shape=None, max_len=None):
    """A dense tensor array: a zero [max_len, *shape] buffer (Fluid's
    empty LOD_TENSOR_ARRAY grows; a dense one needs its extent up front)."""
    if shape is None or max_len is None:
        raise ValueError(
            "create_array needs shape= and max_len= under XLA static "
            "shapes (dense [max_len, ...] buffer); see array_write")
    from .tensor import fill_constant
    return fill_constant(shape=[int(max_len)] + list(shape),
                         dtype=dtype, value=0.0)


def array_length(array):
    """The dense array's leading extent, known when the program is built,
    as an int64 [1] tensor."""
    from .tensor import fill_constant
    return fill_constant(shape=[1], dtype="int64",
                         value=float(int(array.shape[0])))


def is_empty(x, cond=None):
    """numel(x) == 0 (is_empty_op.cc), decided when the op runs."""
    helper = LayerHelper("is_empty")
    out = cond
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="is_empty", inputs={"X": x},
                     outputs={"Out": out})
    return out


def lod_rank_table(x, level=0):
    """Rows ranked by descending length; ``x`` is the Length vector.
    Returns the order (for reorder_lod_tensor_by_rank)."""
    helper = LayerHelper("lod_rank_table")
    order = helper.create_variable_for_type_inference("int32")
    length = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="lod_rank_table", inputs={"X": x},
                     outputs={"Out": order, "Length": length},
                     attrs={"level": level})
    return order


def reorder_lod_tensor_by_rank(x, rank_table):
    """x's batch rows permuted into the rank table's order."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": x, "RankTable": rank_table},
                     outputs={"Out": out})
    return out

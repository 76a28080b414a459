"""Optimizers (counterpart of ``paddle_tpu/optimizer.py``; reference
python/paddle/fluid/optimizer.py). ``minimize`` = ``append_backward`` +
one update op per parameter, appended under
``program._optimized_guard`` so the ops carry the OPTIMIZE role. Only
``Optimizer`` and ``AdamOptimizer`` are ported; the others are ROADMAP
A9. ``fuse_optimizer_update_ops`` is the multi-tensor rewrite behind
``BuildStrategy.fuse_all_optimizer_ops``."""

from __future__ import annotations

from collections import defaultdict

from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops
from .utils import unique_name

__all__ = ["Optimizer", "AdamOptimizer", "fuse_optimizer_update_ops"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators = defaultdict(dict)  # name -> param -> var
        self._learning_rate_map = {}
        self.helper = None

    # -- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self, program):
        if program in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        lr_var = self.helper.create_global_variable(
            name=unique_name.generate("learning_rate"),
            persistable=True, dtype="float32", shape=[1])
        self.helper.set_variable_initializer(
            lr_var, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[program] = lr_var

    def _global_learning_rate(self, program=None):
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if mult != 1.0:
            raise NotImplementedError(
                f"{param.name}: a per-parameter learning rate is not ported "
                "to paddle_tpu_torch yet (ROADMAP A9)")
        return self._global_learning_rate()

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        var = self.helper.create_global_variable(
            name=unique_name.generate(f"{param.name}_{name}"),
            persistable=True, dtype=dtype or param.dtype,
            shape=shape or list(param.shape))
        self.helper.set_variable_initializer(
            var, ConstantInitializer(float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- hooks --------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- the optimization pass ----------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        self.helper = LayerHelper(self.__class__.__name__,
                                  startup_program=startup_program)
        self._create_global_learning_rate(program)
        global_block = program.global_block()
        self._create_accumulators(
            global_block, [p for p, g in parameters_and_grads
                           if g is not None])
        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None:
                continue
            with program._optimized_guard(param_and_grad):
                if getattr(param_and_grad[0], "trainable", True):
                    optimize_ops.append(self._append_optimize_op(
                        global_block, param_and_grad))
        return optimize_ops

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set,
                               callbacks or [error_clip_callback])

    def apply_gradients(self, params_grads, loss, startup_program=None):
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self._create_optimization_pass(params_grads, loss,
                                              startup_program)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Backward and update ops for ``loss``: (optimize_ops,
        params_grads)."""
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads, loss,
                                            startup_program)
        return optimize_ops, params_grads


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)
            self._add_accumulator("beta2_pow_acc", p, shape=[1],
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            type="adam",
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


# the update ops fuse_optimizer_update_ops groups, with their slots: adam
# only (the JAX package also fuses sgd and momentum, which wait for their
# optimizers, ROADMAP A9)
_FUSABLE_UPDATE_OPS = {
    "adam": {"fused_type": "fused_adam",
             "in_slots": ("Param", "Grad", "Moment1", "Moment2",
                          "Beta1Pow", "Beta2Pow", "LearningRate"),
             "out_slots": ("ParamOut", "Moment1Out", "Moment2Out",
                           "Beta1PowOut", "Beta2PowOut")},
}


def fuse_optimizer_update_ops(ops, var_dtype=None):
    """Group per-parameter update ops by (op type, hyperparameter attrs,
    param dtype, grad dtype) and rewrite each group of >= 2 into ONE
    multi-tensor fused op (ir/pipeline.py calls this under
    BuildStrategy.fuse_all_optimizer_ops).

    Safety: a group only fuses when no non-member op between its first
    and last member reads or writes anything a member writes: the fused
    op sits at the LAST member's slot, so every member's inputs are
    already live there and moving the earlier members' writes later must
    be unobservable. Returns (new_ops, ops_removed)."""
    from .core.desc import OpDesc
    from .core.types import (OP_ROLE_ATTR_NAME, OP_ROLE_VAR_ATTR_NAME,
                             OpRole)
    from .ir import analyze

    du = analyze.DefUse(ops)
    groups = {}  # key -> list of (index, op)
    for i, op in enumerate(ops):
        spec = _FUSABLE_UPDATE_OPS.get(op.type)
        if spec is None:
            continue
        # exactly one var per slot, every declared slot present, and no
        # undeclared extra slot (whose semantics the fused emitter would
        # drop)
        if any(len(op.input(s)) != 1 for s in spec["in_slots"]) or \
                any(len(op.output(s)) != 1 for s in spec["out_slots"]):
            continue
        if {s for s, ns in op.inputs.items() if ns} - set(spec["in_slots"]) \
                or {s for s, ns in op.outputs.items() if ns} \
                - set(spec["out_slots"]):
            continue
        hyper = tuple(sorted(
            (k, v) for k, v in op.attrs.items()
            if k not in (OP_ROLE_ATTR_NAME, OP_ROLE_VAR_ATTR_NAME)
            and isinstance(v, (bool, int, float, str))))
        pdt = var_dtype(op.input("Param")[0]) if var_dtype else None
        gdt = var_dtype(op.input("Grad")[0]) if var_dtype else None
        if var_dtype and (pdt != "float32" or gdt != "float32"):
            # non-f32 (or unknown-dtype) params isolate: the bitwise
            # contract holds for f32 groups
            pdt = (pdt, op.input("Param")[0])
        groups.setdefault((op.type, hyper, pdt, gdt), []).append((i, op))

    drop = set()
    fused_at = {}
    removed = 0
    for (op_type, hyper, _pdt, _gdt), members in groups.items():
        if len(members) < 2:
            continue
        spec = _FUSABLE_UPDATE_OPS[op_type]
        idxs = [i for i, _ in members]
        member_writes = set()
        member_reads = set()
        safe = True
        for _, op in members:
            writes = {n for n in op.output_arg_names() if n}
            reads = {n for n in op.input_arg_names() if n}
            # members must be pairwise independent: two updates of the
            # SAME parameter are sequential. Shared reads (the LR var)
            # are fine.
            if writes & member_writes or (writes & member_reads) or (
                    reads & member_writes):
                safe = False
                break
            member_writes |= writes
            member_reads |= reads
        if not safe:
            continue
        if du.group_interference(idxs, member_reads,
                                 member_writes) is not None:
            continue
        ins = {s: [op.input(s)[0] for _, op in members]
               for s in spec["in_slots"]}
        outs = {s: [op.output(s)[0] for _, op in members]
                for s in spec["out_slots"]}
        role_var = []
        for _, op in members:
            role_var.extend(op.attrs.get(OP_ROLE_VAR_ATTR_NAME) or [])
        attrs = dict(members[0][1].attrs)
        attrs[OP_ROLE_ATTR_NAME] = int(OpRole.OPTIMIZE)
        if role_var:
            attrs[OP_ROLE_VAR_ATTR_NAME] = role_var
        fused_at[max(idxs)] = OpDesc(spec["fused_type"], ins, outs, attrs)
        drop.update(i for i in idxs if i != max(idxs))
        removed += len(members) - 1
    if not fused_at:
        return list(ops), 0
    out_ops = []
    for i, op in enumerate(ops):
        if i in drop:
            continue
        out_ops.append(fused_at.get(i, op))
    return out_ops, removed

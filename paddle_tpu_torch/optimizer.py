"""Optimizers (counterpart of ``paddle_tpu/optimizer.py``; reference
python/paddle/fluid/optimizer.py). ``minimize`` = ``append_backward`` +
the clip and regularization ops + one update op per parameter, appended
under ``program._optimized_guard`` so the ops carry the OPTIMIZE role.
Every optimizer of the JAX package is ported, ``ModelAverage`` too. A
parameter's ``optimize_attr["learning_rate"]`` scales the
global rate (a ``scale`` op), or replaces it when it is a Variable
(``append_LARS``). ``fuse_optimizer_update_ops`` is the multi-tensor
rewrite behind ``BuildStrategy.fuse_all_optimizer_ops``."""

from __future__ import annotations

from collections import defaultdict

from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops
from .utils import unique_name

__all__ = ["SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
           "Ftrl", "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer",
           "AdamOptimizer", "AdamaxOptimizer", "DecayedAdagradOptimizer",
           "RMSPropOptimizer", "FtrlOptimizer", "AdadeltaOptimizer",
           "ModelAverage", "LarsMomentum", "LarsMomentumOptimizer",
           "LambOptimizer", "Optimizer", "fuse_optimizer_update_ops"]


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
        """The rate of one parameter's update: the global rate, scaled by
        its ``optimize_attr["learning_rate"]`` (a ``scale`` op), or that
        attr itself when it is a Variable."""
        param = param_and_grad[0]
        base = self._global_learning_rate()
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if isinstance(mult, Variable):
            return mult
        if mult == 1.0:
            return base
        from .layers import nn
        return nn.scale(base, scale=float(mult))

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

    def _finish_update(self, block, parameters_and_grads):
        """Ops after every update op (Adamax's Beta1Pow advance)."""

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
        with program._optimized_guard([]):
            self._finish_update(global_block, parameters_and_grads)
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


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": p, "Grad": g,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": p, "Grad": g, "Velocity": velocity,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "VelocityOut": velocity},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


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


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": p, "Grad": g, "Velocity": velocity,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "VelocityOut": velocity},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": p, "Grad": g, "Moment": moment,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": moment},
            attrs={"epsilon": self._epsilon})


class LambOptimizer(AdamOptimizer):
    """LAMB, the optimizer BASELINE.json names for BERT: Adam's moments,
    a decoupled weight decay and a per-parameter trust ratio."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, weight_decay=0.01, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._weight_decay = weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            type="lamb",
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon,
                   "weight_decay": self._weight_decay})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adamax",
            inputs={"Param": p, "Grad": g,
                    "Moment": self._get_accumulator("moment", p),
                    "InfNorm": self._get_accumulator("inf_norm", p),
                    "Beta1Pow": self._get_accumulator("beta1_pow_acc", p),
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p,
                     "MomentOut": self._get_accumulator("moment", p),
                     "InfNormOut": self._get_accumulator("inf_norm", p)},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, parameters_and_grads):
        for p, g in parameters_and_grads:
            if g is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(type="scale", inputs={"X": b1p},
                            outputs={"Out": b1p},
                            attrs={"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": p, "Grad": g, "Moment": moment,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": moment},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("__avg_squared_grad", p)
        asu = self._get_accumulator("__avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": p, "Grad": g, "AvgSquaredGrad": asg,
                    "AvgSquaredUpdate": asu},
            outputs={"ParamOut": p, "AvgSquaredGradOut": asg,
                     "AvgSquaredUpdateOut": asu},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        outputs = {"ParamOut": p, "MomentOut": mom, "MeanSquareOut": ms}
        if self._centered:
            outputs["MeanGradOut"] = mg
        return block.append_op(
            type="rmsprop",
            inputs={"Param": p, "Grad": g, "Moment": mom, "MeanSquare": ms,
                    "MeanGrad": mg,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs=outputs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": p, "Grad": g, "SquaredAccumulator": sq,
                    "LinearAccumulator": lin,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "SquaredAccumOut": sq,
                     "LinearAccumOut": lin},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class ModelAverage(Optimizer):
    """Parameter averaging for evaluation, as the JAX package's: one EMA
    accumulator per parameter of the default main program (built after
    ``minimize``), ``ema = (1 - rate) * ema + rate * param`` each step
    (a ``scale``, a ``scale`` and an ``elementwise_add``, OPTIMIZE role),
    starting from 0. ``apply(executor)`` is a context manager that puts
    each EMA into its parameter for the body and restores the parameter
    after it. Both copy in place on the device (``copy_``), where the JAX
    package rebinds the names: the values are the same, and the scope
    keeps its tensors, so a captured graph over them is kept."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        program = default_main_program()
        self.helper = LayerHelper("model_average")
        self._ema = {}
        for p in program.global_block().all_parameters():
            ema = self._add_accumulator("ema", p, fill_value=0.0)
            self._ema[p.name] = ema
            with program._optimized_guard([p]):
                decay = 1.0 - self.average_window
                from .layers import nn
                block = program.global_block()
                tmp = nn.scale(ema, scale=decay)
                tmp2 = nn.scale(p, scale=1.0 - decay)
                block.append_op(type="elementwise_add",
                                inputs={"X": tmp, "Y": tmp2},
                                outputs={"Out": ema})

    def apply(self, executor, need_restore=True):
        """A context manager: the global scope's parameters hold their
        EMAs in the body, and their own values again after it unless
        ``need_restore`` is False."""
        import contextlib

        from .executor import global_scope

        @contextlib.contextmanager
        def _guard():
            scope = global_scope()
            backup = {}
            for pname, ema in self._ema.items():
                param = scope.find_var(pname)
                backup[pname] = param.clone()
                param.copy_(scope.find_var(ema.name))
            try:
                yield
            finally:
                if need_restore:
                    for pname, val in backup.items():
                        scope.find_var(pname).copy_(val)

        return _guard()


# the update ops fuse_optimizer_update_ops groups, with their slots
_FUSABLE_UPDATE_OPS = {
    "sgd": {"fused_type": "fused_sgd",
            "in_slots": ("Param", "Grad", "LearningRate"),
            "out_slots": ("ParamOut",)},
    "momentum": {"fused_type": "fused_momentum",
                 "in_slots": ("Param", "Grad", "Velocity",
                              "LearningRate"),
                 "out_slots": ("ParamOut", "VelocityOut")},
    "adam": {"fused_type": "fused_adam",
             "in_slots": ("Param", "Grad", "Moment1", "Moment2",
                          "Beta1Pow", "Beta2Pow", "LearningRate"),
             "out_slots": ("ParamOut", "Moment1Out", "Moment2Out",
                           "Beta1PowOut", "Beta2PowOut")},
}


def fuse_optimizer_update_ops(ops, var_dtype=None):
    """Group per-parameter sgd, momentum and adam update ops by (op type,
    hyperparameter attrs, param dtype, grad dtype) and rewrite each group
    of >= 2 into ONE multi-tensor fused op (ir/pipeline.py calls this
    under BuildStrategy.fuse_all_optimizer_ops).

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


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer

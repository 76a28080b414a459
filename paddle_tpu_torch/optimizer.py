"""Optimizers (counterpart of ``paddle_tpu/optimizer.py``; reference
python/paddle/fluid/optimizer.py). ``minimize`` = ``append_backward`` +
one update op per parameter, appended under
``program._optimized_guard`` so the ops carry the OPTIMIZE role. Only
``Optimizer`` and ``AdamOptimizer`` are ported; the others are ROADMAP
A9."""

from __future__ import annotations

from collections import defaultdict

from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops
from .utils import unique_name

__all__ = ["Optimizer", "AdamOptimizer"]


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

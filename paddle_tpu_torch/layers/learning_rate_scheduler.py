"""Learning-rate schedules (counterpart of
``paddle_tpu/layers/learning_rate_scheduler.py``; reference
python/paddle/fluid/layers/learning_rate_scheduler.py): ops over one
persistable float32 step counter that a single ``increment``, prepended
to the main program, advances every run however many schedules read it.
Each schedule appends the JAX package's op sequence; ``append_LARS``
writes a per-parameter rate into each parameter's ``optimize_attr``."""

from __future__ import annotations

import math

from ..core.types import OpRole
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from . import nn, ops, tensor

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "cosine_decay", "linear_lr_warmup", "append_LARS"]

COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """The float32 [1] step counter, ``begin`` at the first run."""
    helper = LayerHelper("global_step_counter")
    block = helper.main_program.global_block()
    existed = block.has_var(COUNTER_NAME)
    counter = helper.create_global_variable(
        name=COUNTER_NAME, persistable=True, dtype="float32", shape=[1])
    if not existed:
        # one increment per run however many schedules read the counter
        helper.set_variable_initializer(
            counter, ConstantInitializer(float(begin - 1)))
        block._prepend_op(
            type="increment", inputs={"X": [counter.name]},
            outputs={"Out": [counter.name]},
            attrs={"step": 1.0, "op_role": int(OpRole.LRSCHED)})
    counter.stop_gradient = True
    return counter


def _pow_scalar(base, exponent_var, lr):
    """lr * base^exponent, as exp(exponent * log(base))."""
    return nn.scale(ops.exp(nn.scale(exponent_var, scale=math.log(base))),
                    scale=lr)


def _steps_over(decay_steps, staircase):
    """step / decay_steps, floored when ``staircase``."""
    div = _decay_step_counter() * (1.0 / decay_steps)
    return ops.floor(div) if staircase else div


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate^(step / decay_steps)."""
    return _pow_scalar(decay_rate, _steps_over(decay_steps, staircase),
                       learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""
    div = _steps_over(decay_steps, staircase)
    return nn.scale(ops.exp(nn.scale(div, scale=-decay_rate)),
                    scale=learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""
    div = _steps_over(decay_steps, staircase)
    denom = nn.scale(div, scale=decay_rate, bias=1.0)
    one = tensor.fill_constant([1], "float32", learning_rate)
    return nn.elementwise_div(one, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end) * (1 - min(step, decay_steps) / decay_steps)^power +
    end (``cycle`` is accepted and ignored, as in the JAX package)."""
    gs = nn.clip(_decay_step_counter(), 0.0, float(decay_steps))
    frac = nn.scale(gs, scale=1.0 / decay_steps)
    one_minus = nn.scale(frac, scale=-1.0, bias=1.0)
    poly = ops.pow(one_minus, factor=power)
    return nn.scale(poly, scale=(learning_rate - end_learning_rate),
                    bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """values[i] for boundaries[i-1] <= step < boundaries[i], as a sum of
    masked values."""
    assert len(boundaries) + 1 == len(values)
    global_step = _decay_step_counter()
    pieces = []
    for i, v in enumerate(values):
        if i == 0:
            cond = nn.cast(_lt_scalar(global_step, boundaries[0]), "float32")
        elif i == len(values) - 1:
            cond = nn.cast(_ge_scalar(global_step, boundaries[-1]),
                           "float32")
        else:
            c1 = nn.cast(_ge_scalar(global_step, boundaries[i - 1]),
                         "float32")
            c2 = nn.cast(_lt_scalar(global_step, boundaries[i]), "float32")
            cond = nn.elementwise_mul(c1, c2)
        pieces.append(nn.scale(cond, scale=float(v)))
    out = pieces[0]
    for p in pieces[1:]:
        out = nn.elementwise_add(out, p)
    return out


def _compare_scalar(op_type, var, s):
    helper = LayerHelper(op_type)
    y = tensor.fill_constant([1], "float32", float(s))
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type=op_type, inputs={"X": var, "Y": y},
                     outputs={"Out": out})
    return out


def _lt_scalar(var, s):
    return _compare_scalar("less_than", var, s)


def _ge_scalar(var, s):
    return _compare_scalar("greater_equal", var, s)


def noam_decay(d_model, warmup_steps):
    """The Transformer schedule: d_model^-0.5 * min(step^-0.5,
    step * warmup_steps^-1.5)."""
    global_step = _decay_step_counter(1)
    a = ops.pow(global_step, factor=-0.5)
    b = nn.scale(global_step, scale=warmup_steps ** -1.5)
    m = nn.elementwise_min(a, b)
    return nn.scale(m, scale=d_model ** -0.5)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr / 2 * (1 + cos(pi * floor(step / step_each_epoch) / epochs))."""
    global_step = _decay_step_counter()
    epoch_f = nn.scale(global_step, scale=1.0 / step_each_epoch)
    cos_arg = nn.scale(ops.floor(epoch_f), scale=math.pi / epochs)
    return nn.scale(ops.cos(cos_arg), scale=0.5 * learning_rate,
                    bias=0.5 * learning_rate, bias_after_scale=True)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr + (end_lr - start_lr) * step / warmup_steps before
    warmup_steps, then ``learning_rate`` (a number or a schedule's
    Variable)."""
    global_step = _decay_step_counter()
    frac = nn.clip(nn.scale(global_step, scale=1.0 / warmup_steps), 0.0, 1.0)
    warm = nn.scale(frac, scale=(end_lr - start_lr), bias=start_lr)
    if not hasattr(learning_rate, "name"):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    done = nn.cast(_ge_scalar(global_step, warmup_steps), "float32")
    not_done = nn.scale(done, scale=-1.0, bias=1.0)
    return nn.elementwise_add(nn.elementwise_mul(warm, not_done),
                              nn.elementwise_mul(learning_rate, done))


def append_LARS(params_grads, learning_rate, weight_decay):
    """Layer-wise adaptive rates (You et al., arXiv:1708.03888): lr_p = lr
    * ||p|| / (||g|| + weight_decay * ||p||), written into each
    parameter's ``optimize_attr`` for the optimizer's per-parameter
    rate."""
    decayed = []
    for param, grad in params_grads:
        param_norm = ops.sqrt(nn.reduce_sum(ops.square(param)))
        grad_norm = ops.sqrt(nn.reduce_sum(ops.square(grad)))
        denom = grad_norm + weight_decay * param_norm
        decayed_lr = nn.elementwise_div(
            nn.elementwise_mul(learning_rate, param_norm), denom)
        param.optimize_attr["learning_rate"] = decayed_lr
        decayed.append(decayed_lr)
    return decayed

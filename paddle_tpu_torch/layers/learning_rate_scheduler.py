"""Learning-rate schedules (reference
python/paddle/fluid/layers/learning_rate_scheduler.py): ops over a
persistable step counter that one ``increment``, prepended to the main
program, advances every run. Only ``noam_decay`` is ported; the other
schedules are ROADMAP A9."""

from __future__ import annotations

from ..core.types import OpRole
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from . import nn, ops

__all__ = ["noam_decay"]

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


def noam_decay(d_model, warmup_steps):
    """The Transformer schedule: d_model^-0.5 * min(step^-0.5,
    step * warmup_steps^-1.5)."""
    global_step = _decay_step_counter(1)
    a = ops.pow(global_step, factor=-0.5)
    b = nn.scale(global_step, scale=warmup_steps ** -1.5)
    m = nn.elementwise_min(a, b)
    return nn.scale(m, scale=d_model ** -0.5)

"""Gradient clipping (counterpart of ``paddle_tpu/clip.py``; reference
python/paddle/fluid/clip.py): ``ErrorClipByValue``,
``GradientClipByValue``, ``GradientClipByNorm`` and
``GradientClipByGlobalNorm``, set on parameters by ``set_gradient_clip``
and appended by ``append_gradient_clip_ops`` as grad-transform ops before
the update ops, in the JAX package's op sequence. ``error_clip_callback``
is the backward's per-op callback; as in the JAX package it appends
nothing."""

from __future__ import annotations

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops", "error_clip_callback"]


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def append_clip_op(self, block, grad_name):
        block.append_op(type="clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max})


def error_clip_callback(block, context):
    """The backward's per-op callback (appends nothing, as in the JAX
    package)."""


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def _create_operators(self, param, grad):
        from .layers import nn
        return param, nn.clip(grad, self.min, self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _create_operators(self, param, grad):
        from .layers import nn
        return param, nn.clip_by_norm(grad, self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """g_i *= clip_norm / max(global_norm, clip_norm), the global norm the
    sqrt of one ``sum`` of every gradient's sum of squares in its group."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        from .layers import nn
        sq = nn.reduce_sum(nn.elementwise_mul(grad, grad))
        context.setdefault(self.group_name, []).append((param, grad, sq))

    def _create_operators(self, param, grad):
        from .layers import nn, ops, tensor
        ctx = _global_clip_context.get(self.group_name)
        if ctx is None or "scale" not in ctx:
            sqs = [s for (_, _, s) in
                   _global_clip_context["raw"][self.group_name]]
            total = sqs[0]
            block = grad.block
            if len(sqs) > 1:
                total = block.create_var(dtype=grad.dtype, shape=[1])
                block.append_op(type="sum", inputs={"X": sqs},
                                outputs={"Out": total})
            gnorm = ops.sqrt(total)
            cn = tensor.fill_constant([1], "float32", self.clip_norm)
            scale_var = nn.elementwise_div(cn, nn.elementwise_max(gnorm, cn))
            _global_clip_context.setdefault(self.group_name, {})[
                "scale"] = scale_var
        scale_var = _global_clip_context[self.group_name]["scale"]
        return param, nn.elementwise_mul(grad, scale_var, axis=0)


# the squares of each global-norm group ("raw") and, once made, each
# group's scale; reset by every append_gradient_clip_ops
_global_clip_context = {"raw": {}}


def set_gradient_clip(clip, param_list=None, program=None):
    """Give ``clip`` to the parameters of ``param_list`` (names or
    Parameters), by default to every parameter of ``program``."""
    from .framework import default_main_program
    program = program or default_main_program()
    params = param_list or program.global_block().all_parameters()
    for p in params:
        if not hasattr(p, "name"):
            p = program.global_block().var(p)
        p.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    """The (param, grad) pairs after each parameter's clip attr: the
    context pass over every pair (the global norm's squares), then each
    pair's clip ops, all under the OPTIMIZE role. Unchanged when no
    parameter has a clip attr."""
    _global_clip_context.clear()
    _global_clip_context["raw"] = {}
    if not any(g is not None and getattr(p, "gradient_clip_attr", None)
               is not None for p, g in param_grads):
        return param_grads

    program = param_grads[0][0].block.program
    for p, g in param_grads:
        if g is None:
            continue
        clip_attr = getattr(p, "gradient_clip_attr", None) or \
            NullGradientClipAttr()
        with program._optimized_guard([p, g]):
            clip_attr._process_context(_global_clip_context["raw"], p, g)

    res = []
    for p, g in param_grads:
        if g is None:
            res.append((p, g))
            continue
        clip_attr = getattr(p, "gradient_clip_attr", None) or \
            NullGradientClipAttr()
        with program._optimized_guard([p, g]):
            res.append(clip_attr._create_operators(p, g))
    return res

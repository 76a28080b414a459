"""Gradient clipping (counterpart of ``paddle_tpu/clip.py``): what
``Optimizer.minimize`` reaches when no parameter asks for a clip. The clip
attrs themselves (ErrorClipByValue, GradientClipBy*) are ROADMAP A9."""

from __future__ import annotations

__all__ = ["append_gradient_clip_ops", "error_clip_callback"]


def error_clip_callback(block, context):
    """The backward's per-op callback: no error clip is ported."""


def append_gradient_clip_ops(param_grads):
    """``param_grads`` as they are when no parameter has a clip attr;
    raises for one that has."""
    for p, g in param_grads:
        if g is not None and getattr(p, "gradient_clip_attr", None) is not None:
            raise NotImplementedError(
                f"gradient clipping ({p.name}) is not ported to "
                "paddle_tpu_torch yet (ROADMAP A9)")
    return param_grads

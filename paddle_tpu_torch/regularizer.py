"""Weight decay (counterpart of ``paddle_tpu/regularizer.py``): what
``Optimizer.minimize`` reaches with no regularization. L1/L2 decay are
ROADMAP A9."""

from __future__ import annotations

__all__ = ["append_regularization_ops"]


def append_regularization_ops(parameters_and_grads, regularization=None):
    """``parameters_and_grads`` unchanged when neither a parameter nor the
    optimizer names a regularizer; raises when one does."""
    for param, grad in parameters_and_grads:
        if grad is not None and (getattr(param, "regularizer", None)
                                 or regularization) is not None:
            raise NotImplementedError(
                f"regularization ({param.name}) is not ported to "
                "paddle_tpu_torch yet (ROADMAP A9)")
    return parameters_and_grads

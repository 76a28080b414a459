"""bf16 mixed precision (counterpart of
``paddle_tpu/contrib/mixed_precision.py``): ``decorate(program)`` flags
the program for autocast. Matrix-product ops then compute in bf16 with
bf16 outputs, elementwise ops meeting a bf16 activation stay in bf16, and
master weights, optimizer state, normalization statistics and the loss
stay fp32. bf16 has fp32's exponent range, so there is no loss scaling."""

from __future__ import annotations

from ..framework import Program, default_main_program

__all__ = ["decorate"]


def decorate(program: Program = None, enable: bool = True) -> Program:
    """Enable (or disable) bf16 autocast for every op of ``program``."""
    program = program or default_main_program()
    program._amp = enable
    program._bump()
    return program

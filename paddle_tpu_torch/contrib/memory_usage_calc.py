"""Program memory estimator (contrib/memory_usage_calc.py parity;
counterpart of ``paddle_tpu/contrib/memory_usage_calc.py``).

Walks block-0 op outputs, sizes each dense tensor var from its desc
shape (one -1 dim allowed, resolved against batch_size) and reports an
estimated activation+param footprint range: the knob users turn to pick
a batch size that fills the card's memory. The allocator's real peak
also depends on when temporaries die, hence the same 5-10% slack band
the reference applies (profiling/memory.py is the liveness analysis).
"""

from __future__ import annotations

import numpy as _np

from ..core.types import VarType, dtype_to_numpy
from ..framework import Program

__all__ = ["memory_usage"]


def memory_usage(program, batch_size):
    """Estimate `program`'s memory footprint at `batch_size`.

    Returns (lower, upper, unit) with unit in B/KB/MB like the
    reference (contrib/memory_usage_calc.py:44 `memory_usage`)."""
    if not isinstance(program, Program):
        raise TypeError("memory_usage expects a Program, got "
                        f"{type(program).__name__}")
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")

    block = program.global_block().desc
    seen = set()
    total = 0.0
    for op in block.ops:
        for name in op.output_arg_names():
            if not name or name in seen:
                continue
            seen.add(name)
            vd = block.vars.get(name)
            if vd is None or vd.type != VarType.DENSE_TENSOR \
                    or not vd.shape:
                continue
            count = 1
            neg_dims = 0
            for d in vd.shape:
                if d is None:
                    continue
                if d < 0:
                    neg_dims += 1
                    if neg_dims > 1:
                        raise ValueError(
                            f"var {name} has more than one dynamic dim")
                    count *= batch_size * (-d)
                else:
                    count *= d
            try:
                itemsize = _np.dtype(dtype_to_numpy(vd.dtype)).itemsize
            except (KeyError, ValueError, TypeError):
                itemsize = 4
            total += count * itemsize

    unit = "B"
    for next_unit in ("KB", "MB"):
        if total > 1024:
            total /= 1024
            unit = next_unit
    return total * 1.05, total * 1.1, unit

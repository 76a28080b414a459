"""Eager rematerialisation (activation checkpointing) for dygraph mode
(counterpart of ``paddle_tpu/imperative/recompute.py``).

Every traced op keeps the tensors its backward needs alive until the
backward. ``recompute(fn, *inputs)`` runs ``fn`` once without autograd
(the tracer paused) and records one node, a ``torch.autograd.Function``
that keeps only the inputs, the parameters and the tracer generator's
state. Its backward restores that state, runs ``fn`` again with grad
enabled and takes the gradients of the inputs and the parameters, so
between checkpoints only the inputs stay resident (the RecomputeOptimizer
of dygraph).

Layers work: the parameters reachable through ``fn.parameters()`` (or
passed as ``params=[...]``) are differentiated through the boundary.
Dropout is replayed bit-exactly from the saved generator state, and the
live state is put back after the replay, so the draws after
``backward()`` go on where the forward left them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .tracer import VarBase, _TapeNode, _active_tracer


def _as_list(outs):
    return list(outs) if isinstance(outs, (tuple, list)) else [outs]


def _result(outs):
    return outs if not isinstance(outs, (tuple, list)) or len(outs) > 1 \
        else outs[0]


class _Checkpoint(torch.autograd.Function):
    """forward(region, *tensors) -> fn's output tensors; ``tensors`` are
    the region's inputs then its parameters (so autograd routes their
    gradients here)."""

    @staticmethod
    def forward(ctx, region, *tensors):
        ctx.region = region
        ctx.save_for_backward(*tensors[:region.n_in])
        outs = region.run(tensors[:region.n_in], replay=False)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cots):
        region = ctx.region
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(g) for t, g in
                      zip(inputs, region.in_grad)]
            outs = region.run(leaves, replay=True)
        wrt = [t for t, g in zip(leaves, region.in_grad) if g]
        wrt += [p.array for p in region.params]
        pairs = [(o, c) for o, c in zip(outs, cots)
                 if o.requires_grad and c is not None]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    wrt, [c for _, c in pairs],
                                    allow_unused=True) if pairs else \
            [None] * len(wrt)
        it = iter(grads)
        in_grads = [next(it) if g else None for g in region.in_grad]
        return (None, *in_grads, *it)


class _Region:
    """What a checkpoint keeps: ``fn``, the input VarBases' flags and
    names, the parameters and the generator state at the boundary."""

    def __init__(self, tracer, fn, in_vars, params):
        self.tracer, self.fn, self.params = tracer, fn, params
        self.n_in = len(in_vars)
        self.in_grad = [not v.stop_gradient and v.array.is_floating_point()
                        for v in in_vars]
        self.names = [v.name for v in in_vars]
        self.rng_state = tracer.generator.get_state()

    def run(self, tensors, replay: bool):
        """fn on fresh VarBases over ``tensors``, the tracer paused and
        its generator at the boundary's state. A replay puts the live
        state back afterwards; the forward leaves the stream past the
        region."""
        tracer = self.tracer
        live = tracer.generator.get_state() if replay else None
        tracer.generator.set_state(self.rng_state)
        was_paused, tracer.paused = tracer.paused, True
        try:
            vs = [VarBase._wrap(t, not g, n) for t, g, n in
                  zip(tensors, self.in_grad, self.names)]
            return [o.array for o in _as_list(self.fn(*vs))]
        finally:
            tracer.paused = was_paused
            if replay:
                tracer.generator.set_state(live)


def recompute(fn, *inputs, params: Optional[Sequence[VarBase]] = None):
    """Checkpoint boundary: ``y = recompute(block, x)`` behaves like
    ``y = block(x)`` but keeps no activation of ``block`` for the
    backward."""
    tracer = _active_tracer()
    in_vars: List[VarBase] = [
        v if isinstance(v, VarBase) else VarBase(v, stop_gradient=True)
        for v in inputs]

    if tracer.paused:
        # a nested checkpoint, or the replay of an enclosing one: the
        # outer region's graph runs straight through
        return _result(fn(*in_vars))

    if params is None and hasattr(fn, "parameters"):
        params = [p for p in fn.parameters() if not p.stop_gradient]
    # a Layer lists a parameter under its name and under the attribute
    # holding it: differentiate each once
    params = list({id(p): p for p in params or []}.values())
    region = _Region(tracer, fn, in_vars, params)
    needs_grad = tracer.train_mode and (any(region.in_grad) or params)
    if not needs_grad:
        with torch.no_grad():
            outs = region.run([v.array for v in in_vars], replay=False)
        return _result([VarBase._wrap(o, True) for o in outs])

    outs = _Checkpoint.apply(region, *[v.array.detach() if v.stop_gradient
                                       else v.array for v in in_vars],
                             *[p.array for p in params])
    out_vars = [VarBase._wrap(o, not o.requires_grad) for o in outs]
    tracer.record(_TapeNode("recompute", in_vars + params))
    return _result(out_vars)

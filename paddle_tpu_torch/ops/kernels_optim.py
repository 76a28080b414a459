"""Optimizer update ops (counterpart of ``paddle_tpu/ops/kernels_optim.py``):
``sgd``, ``momentum``, ``lars_momentum``, ``adam``, ``lamb``, ``adamax``,
``adagrad``, ``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``,
``proximal_gd``, ``proximal_adagrad`` and the multi-tensor forms
``fused_sgd``, ``fused_momentum`` and ``fused_adam``, in plain torch ops
(the JAX package has no hand kernel for any). Each computes its JAX op's
float32 operations per element in the same order. ParamOut rebinds the
parameter's name, so the executor writes the updated tensor back into the
scope; the update is not in place."""

from __future__ import annotations

import torch

from ..registry import register_op
from .common import same_shape_infer, slots_like_infer


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


def _update(name):
    """Register an update op: no grad, ParamOut shaped as Param."""
    return register_op(name, no_grad=True,
                       infer=same_shape_infer("ParamOut", "Param"))


@_update("sgd")
def sgd(ctx, ins, attrs):
    p = ins["Param"][0]
    return {"ParamOut": [p - _lr(ins) * ins["Grad"][0].to(p.dtype)]}


@register_op("momentum", no_grad=True,
             infer=same_shape_infer("ParamOut", "Param"))
def momentum(ctx, ins, attrs):
    """v' = mu v + g; p' = p - lr v', or with use_nesterov
    p' = p - (g + mu v') lr, in the JAX package's order of operations."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = ins["LearningRate"][0].reshape(())
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register_op("adam", no_grad=True,
             infer=same_shape_infer("ParamOut", "Param"))
def adam(ctx, ins, attrs):
    """Adam with the bias corrections folded into the step size, in the
    JAX package's order of operations."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = (ins["LearningRate"][0].reshape(())
          * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(())))
    g = g.to(p.dtype)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    p_out = p - lr * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out],
            "Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}


@_update("lars_momentum")
def lars_momentum(ctx, ins, attrs):
    """Momentum with the layer-wise rate lr * coeff * ||p|| / (||g|| +
    decay ||p|| + 1e-12) on g + decay p."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    p_norm = torch.sqrt(torch.sum(p * p))
    g_norm = torch.sqrt(torch.sum(g * g))
    local_lr = _lr(ins) * coeff * p_norm / (g_norm + decay * p_norm + 1e-12)
    v_out = mu * v + local_lr * (g + decay * p)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


@_update("lamb")
def lamb(ctx, ins, attrs):
    """LAMB: Adam's bias-corrected direction plus weight decay, scaled by
    the trust ratio ||p|| / ||r|| (1 where either norm is 0, as for a
    zero-initialised bias)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    m1_hat = m1_out / (1 - b1p.reshape(()))
    m2_hat = m2_out / (1 - b2p.reshape(()))
    r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(p * p))
    r_norm = torch.sqrt(torch.sum(r * r))
    trust = torch.where(p_norm * r_norm > 0, p_norm / r_norm, 1.0)
    p_out = p - _lr(ins) * trust * r
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out],
            "Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}


@_update("adamax")
def adamax(ctx, ins, attrs):
    """Adam with the infinity norm; Beta1Pow advances in a separate scale
    op (``AdamaxOptimizer._finish_update``)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins) / (1 - ins["Beta1Pow"][0].reshape(()))
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g))
    p_out = p - lr * m_out / (inf_out + eps)
    return {"ParamOut": [p_out], "MomentOut": [m_out],
            "InfNormOut": [inf_out]}


@_update("adagrad")
def adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    m_out = mom + g * g
    p_out = p - _lr(ins) * g / (torch.sqrt(m_out) + attrs.get("epsilon", 1e-6))
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


@_update("decayed_adagrad")
def decayed_adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    m_out = decay * mom + (1 - decay) * g * g
    p_out = p - _lr(ins) * g / (torch.sqrt(m_out) + attrs.get("epsilon", 1e-6))
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


@_update("adadelta")
def adadelta(ctx, ins, attrs):
    """No learning rate: the step is sqrt((E[dx^2] + eps) / (E[g^2] +
    eps)) g."""
    p, g = ins["Param"][0], ins["Grad"][0]
    avg_sq_g = ins["AvgSquaredGrad"][0]
    avg_sq_u = ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg_out = rho * avg_sq_g + (1 - rho) * g * g
    update = -torch.sqrt((avg_sq_u + eps) / (asg_out + eps)) * g
    asu_out = rho * avg_sq_u + (1 - rho) * update * update
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [asg_out],
            "AvgSquaredUpdateOut": [asu_out]}


@_update("rmsprop")
def rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    lr = _lr(ins)
    ms_out = rho * ms + (1 - rho) * g * g
    if attrs.get("centered", False):
        mg_out = rho * ins["MeanGrad"][0] + (1 - rho) * g
        mom_out = mu * mom + lr * g / torch.sqrt(ms_out - mg_out * mg_out
                                                 + eps)
        return {"ParamOut": [p - mom_out], "MomentOut": [mom_out],
                "MeanSquareOut": [ms_out], "MeanGradOut": [mg_out]}
    mom_out = mu * mom + lr * g / torch.sqrt(ms_out + eps)
    return {"ParamOut": [p - mom_out], "MomentOut": [mom_out],
            "MeanSquareOut": [ms_out]}


@_update("ftrl")
def ftrl(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + g * g
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        sigma = (new_sq ** -lr_power - sq ** -lr_power) / lr
        denom = new_sq ** -lr_power / lr + 2 * l2
    lin_out = lin + g - sigma * p
    pre = torch.minimum(torch.maximum(lin_out, torch.tensor(
        -l1, dtype=lin_out.dtype)), torch.tensor(l1, dtype=lin_out.dtype)) \
        - lin_out
    return {"ParamOut": [pre / denom], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_out]}


def _prox(prox, lr, l1, l2):
    """The L1 soft threshold (when l1 > 0), then the L2 shrink."""
    if l1 > 0:
        prox = torch.sign(prox) * torch.maximum(
            torch.abs(prox) - lr * l1, torch.zeros((), dtype=prox.dtype))
    return prox / (1.0 + lr * l2)


@_update("proximal_gd")
def proximal_gd(ctx, ins, attrs):
    p = ins["Param"][0]
    lr = _lr(ins)
    prox = p - lr * ins["Grad"][0].to(p.dtype)
    return {"ParamOut": [_prox(prox, lr, attrs.get("l1", 0.0),
                               attrs.get("l2", 0.0))]}


@_update("proximal_adagrad")
def proximal_adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    m_out = mom + g * g
    eff_lr = _lr(ins) / torch.sqrt(m_out)
    prox = p - eff_lr * g.to(p.dtype)
    return {"ParamOut": [_prox(prox, eff_lr, attrs.get("l1", 0.0),
                               attrs.get("l2", 0.0))],
            "MomentOut": [m_out]}


def _flat_group(tensors, dtype=None):
    """Per-parameter tensors -> one flat vector, with the sizes and
    shapes that split it back."""
    sizes = [t.numel() for t in tensors]
    shapes = [tuple(t.shape) for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return (flat if dtype is None else flat.to(dtype)), sizes, shapes


def _split_group(flat, sizes, shapes):
    """The flat vector back in the parameters' shapes (views of it)."""
    return [part.view(shape)
            for part, shape in zip(torch.split(flat, sizes), shapes)]


def _scalar_list(vals):
    """Per-parameter [1]-shaped tensors -> one [N] vector."""
    return torch.cat([v.reshape(1) for v in vals])


def _stretch(vals, sizes):
    """Per-parameter [1]-shaped tensors -> one value per element of each
    parameter's segment (a copy of expanded views; repeat_interleave
    would first build an int64 index of every element)."""
    return torch.cat([v.reshape(1).expand(n) for v, n in zip(vals, sizes)])


@register_op("fused_sgd", no_grad=True)
def fused_sgd(ctx, ins, attrs):
    """The multi-tensor sgd update ``fuse_optimizer_update_ops`` writes
    for a group of per-parameter sgd ops: one flat vector each of
    parameters and gradients, the learning rate stretched over each
    parameter's segment; bitwise equal to the per-parameter ops."""
    p, sizes, shapes = _flat_group(ins["Param"])
    g, _, _ = _flat_group(ins["Grad"], dtype=p.dtype)
    lr_seg = _stretch(ins["LearningRate"], sizes).to(p.dtype)
    return {"ParamOut": _split_group(p - lr_seg * g, sizes, shapes)}


@register_op("fused_momentum", no_grad=True)
def fused_momentum(ctx, ins, attrs):
    """The multi-tensor momentum update ``fuse_optimizer_update_ops``
    writes for a group of per-parameter momentum ops: parameters,
    gradients and velocities flattened into one vector each and updated
    in one pass, the learning rate stretched over each parameter's
    segment. Each element goes through ``momentum``'s float32 operations
    in the same order, so the results are bitwise equal to the
    per-parameter ops'."""
    p, sizes, shapes = _flat_group(ins["Param"])
    g, _, _ = _flat_group(ins["Grad"])
    v, _, _ = _flat_group(ins["Velocity"])
    mu = attrs.get("mu", 0.9)
    lr_seg = _stretch(ins["LearningRate"], sizes).to(p.dtype)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr_seg
    else:
        p_out = p - lr_seg * v_out
    return {"ParamOut": _split_group(p_out, sizes, shapes),
            "VelocityOut": _split_group(v_out, sizes, shapes)}


@register_op("fused_adam", no_grad=True)
def fused_adam(ctx, ins, attrs):
    """The multi-tensor Adam update ``fuse_optimizer_update_ops`` writes
    for a group of per-parameter adam ops: the group's parameters,
    gradients and moments flattened into one vector each (``torch.cat``)
    and updated in one pass of elementwise ops, with the step size of
    each parameter stretched over its segment. Each element goes through
    the same float32 operations, in the same order, as ``adam``, so the
    results are bitwise equal to the per-parameter ops'."""
    p, sizes, shapes = _flat_group(ins["Param"])
    g, _, _ = _flat_group(ins["Grad"], dtype=p.dtype)
    m1, _, _ = _flat_group(ins["Moment1"])
    m2, _, _ = _flat_group(ins["Moment2"])
    b1p = _scalar_list(ins["Beta1Pow"])
    b2p = _scalar_list(ins["Beta2Pow"])
    lr = _scalar_list(ins["LearningRate"])
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    # adam's scalar step size per parameter, vectorized over [N], then
    # one value per element of the parameter's segment
    lr_eff = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    lr_seg = _stretch(lr_eff, sizes)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    p_out = p - lr_seg * m1_out / (torch.sqrt(m2_out) + eps)
    b1p_out, b2p_out = b1p * b1, b2p * b2
    n = len(sizes)
    return {"ParamOut": _split_group(p_out, sizes, shapes),
            "Moment1Out": _split_group(m1_out, sizes, shapes),
            "Moment2Out": _split_group(m2_out, sizes, shapes),
            "Beta1PowOut": [b1p_out[i:i + 1] for i in range(n)],
            "Beta2PowOut": [b2p_out[i:i + 1] for i in range(n)]}


_K_MAX_NUM_ACCUMULATES = 16384  # average_accumulates_op.h:28


@register_op("average_accumulates", no_grad=True, infer=slots_like_infer(
    ("out_sum_1", "in_sum_1"), ("out_sum_2", "in_sum_2"),
    ("out_sum_3", "in_sum_3"),
    ("out_num_accumulates", "in_num_accumulates"),
    ("out_old_num_accumulates", "in_old_num_accumulates"),
    ("out_num_updates", "in_num_updates")))
def average_accumulates(ctx, ins, attrs):
    """average_accumulates_op.h (the reference's ModelAverage): sum_1 +=
    param each step; every kMaxNumAccumulates updates sum_1 drains into
    sum_2; when the window closes, sum_3 is overwritten with sum_1 +
    sum_2 and the window starts again. The window is num_updates *
    average_window in float32, truncated, as the JAX op computes it; the
    counters stay int64 (the JAX package's are int32)."""
    p = ins["Param"][0]
    s1, s2, s3 = (ins["in_sum_1"][0], ins["in_sum_2"][0],
                  ins["in_sum_3"][0])
    num_acc = ins["in_num_accumulates"][0]
    old_num = ins["in_old_num_accumulates"][0]
    num_upd = ins["in_num_updates"][0]
    avg_window = attrs.get("average_window", 0.0)
    max_avg = attrs.get("max_average_window", 10000)
    min_avg = attrs.get("min_average_window", 10000)

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + p
    drain = (num_upd % _K_MAX_NUM_ACCUMULATES) == 0
    s2 = torch.where(drain, s2 + s1, s2)
    s1 = torch.where(drain, torch.zeros_like(s1), s1)
    window = torch.clamp((num_upd.to(torch.float32) * avg_window)
                         .to(num_upd.dtype), max=max_avg)
    roll = (num_acc >= min_avg) & (num_acc >= window)
    s3 = torch.where(roll, s1 + s2, s3)
    s1 = torch.where(roll, torch.zeros_like(s1), s1)
    s2 = torch.where(roll, torch.zeros_like(s2), s2)
    old_num = torch.where(roll, num_acc, old_num)
    num_acc = torch.where(roll, torch.zeros_like(num_acc), num_acc)
    return {"out_sum_1": [s1], "out_sum_2": [s2], "out_sum_3": [s3],
            "out_num_accumulates": [num_acc],
            "out_old_num_accumulates": [old_num],
            "out_num_updates": [num_upd]}

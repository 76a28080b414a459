"""The ResNet path's op emitters in the port against the JAX package's, on
the same numpy inputs (seeded), on the CPU: conv2d and depthwise_conv2d
(strides, paddings, dilations, groups, NHWC, the fused ReLU, AMP),
pool2d (max and average, exclusive or not, ceil_mode, global, adaptive,
padding equal to the kernel, NHWC), batch_norm (training and test, NCHW,
NHWC, bf16), cross_entropy (ignore_index, int32 and int64 labels, soft
labels), accuracy, top_k, mean, momentum (with Nesterov), transpose,
affine_channel, conv2d_fusion and fused_conv2d; the conv2d_grad emitter
against the generic vjp; and the gradients through pool2d and relu where
values tie.

Tolerances: fp32 outputs within 1e-5 of the output's largest magnitude
(convolutions and the statistics' sums add in another order in XLA and
torch; measured at most 2e-6), integer outputs exact; bf16 outputs
within 2^-7 of the largest magnitude (one bf16 ulp there: the two round
the same fp32 values, whose last bits differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import registry as jreg

import paddle_tpu_torch  # noqa: F401  (registers the emitters)
from paddle_tpu_torch import registry as preg

RNG = np.random.RandomState(8)


def f32(*shape):
    return RNG.randn(*shape).astype(np.float32)


def _np(v):
    v = v.detach().float() if isinstance(v, torch.Tensor) else v
    return np.asarray(v, dtype=np.float32) if not isinstance(
        v, torch.Tensor) else v.numpy()


def _both(op_type, ins, attrs, amp=False, bf16=()):
    """The op in both packages; inputs in `bf16` go in as bfloat16."""
    def jin(s, a):
        return jnp.asarray(a, jnp.bfloat16 if s in bf16 else None)

    def pin(s, a):
        t = torch.from_numpy(np.array(a))
        return t.to(torch.bfloat16) if s in bf16 else t

    jouts = jreg.lookup(op_type).emitter(
        jreg.EmitContext(amp=amp),
        {s: [jin(s, a) for a in v] for s, v in ins.items()}, attrs)
    pouts = preg.lookup(op_type).emitter(
        preg.EmitContext(torch.device("cpu"), amp=amp),
        {s: [pin(s, a) for a in v] for s, v in ins.items()}, attrs)
    return jouts, pouts


def _check(jouts, pouts, slots=None):
    assert set(pouts) >= set(slots or jouts)
    for slot in slots or jouts:
        for j, p in zip(jouts[slot], pouts[slot]):
            assert tuple(p.shape) == tuple(j.shape), slot
            jdt = str(j.dtype)
            if jdt.startswith("float") or jdt == "bfloat16":
                assert str(p.dtype).replace("torch.", "") == jdt, slot
            jn = np.asarray(j.astype(jnp.float32) if jdt == "bfloat16"
                            else j)
            pn = _np(p)
            if jdt.startswith("int") or jdt == "bool":
                np.testing.assert_array_equal(pn, jn, err_msg=slot)
                continue
            # windows wholly in the padding: -inf (max) or 0/0 (average)
            # on both sides
            fin = np.isfinite(jn)
            np.testing.assert_array_equal(pn[~fin], jn[~fin], err_msg=slot)
            jn, pn = jn[fin], pn[fin]
            scale = max(float(np.abs(jn).max()), 1e-30)
            rel = 2.0 ** -7 if jdt == "bfloat16" else 1e-5
            err = float(np.abs(pn - jn).max())
            assert err <= rel * scale, (slot, err, scale)


def _conv_attrs(**kw):
    attrs = {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
             "groups": 1}
    attrs.update(kw)
    return attrs


CONV = {
    "plain": ((2, 4, 9, 7), (6, 4, 3, 3), _conv_attrs()),
    "stride_pad": ((2, 4, 9, 7), (6, 4, 3, 3),
                   _conv_attrs(strides=[2, 1], paddings=[1, 2])),
    "dilation": ((2, 4, 11, 10), (5, 4, 3, 2),
                 _conv_attrs(dilations=[2, 3], paddings=[2, 1])),
    "groups": ((2, 6, 8, 8), (9, 2, 3, 3),
               _conv_attrs(groups=3, paddings=[1, 1])),
    "resnet_stem": ((2, 3, 32, 32), (8, 3, 7, 7),
                    _conv_attrs(strides=[2, 2], paddings=[3, 3])),
    "one_by_one_stride2": ((2, 8, 9, 9), (16, 8, 1, 1),
                           _conv_attrs(strides=[2, 2])),
    "nhwc": ((2, 4, 9, 7), (6, 4, 3, 3),
             _conv_attrs(strides=[2, 2], paddings=[1, 1],
                         data_format="NHWC")),
}


def _conv_inputs(x_shape, w_shape, attrs):
    x = f32(*x_shape)
    if attrs.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return {"Input": [x], "Filter": [f32(*w_shape) * 0.3]}


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("name", sorted(CONV))
def test_conv2d_matches_jax(name, amp):
    ins = _conv_inputs(*CONV[name])
    _check(*_both("conv2d", ins, CONV[name][2], amp=amp))


@pytest.mark.parametrize("fuse_relu", [False, True])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_depthwise_conv2d_matches_jax(fmt, fuse_relu):
    attrs = _conv_attrs(groups=6, paddings=[1, 1], strides=[2, 2],
                        data_format=fmt,
                        fuse_relu_before_depthwise_conv=fuse_relu)
    ins = _conv_inputs((2, 6, 9, 8), (6, 1, 3, 3), attrs)
    _check(*_both("depthwise_conv2d", ins, attrs))


def _grad_ins(op_type, ins, attrs, amp=False):
    fwd = preg.lookup(op_type).emitter(
        preg.EmitContext(torch.device("cpu"), amp=amp),
        {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}, attrs)
    out = fwd["Output"][0]
    g = RNG.randn(*out.shape).astype(np.float32)
    gins = {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}
    gins["Output@GRAD"] = [torch.from_numpy(g).to(out.dtype)]
    return gins


GRAD_CASES = dict(CONV, depthwise_relu_nhwc=(
    (2, 6, 9, 8), (6, 1, 3, 3),
    _conv_attrs(groups=6, paddings=[1, 1], data_format="NHWC",
                fuse_relu_before_depthwise_conv=True)))


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_conv2d_grad_emitter_matches_generic_vjp(name, amp):
    """The custom conv2d_grad (aten.convolution_backward, no forward
    recompute) against the generic vjp of the forward emitter: the same
    gradients, in the same dtypes."""
    x_shape, w_shape, attrs = GRAD_CASES[name]
    op_type = ("depthwise_conv2d" if attrs.get("groups") == x_shape[1]
               else "conv2d")
    ins = _conv_inputs(x_shape, w_shape, attrs)
    gins = _grad_ins(op_type, ins, attrs, amp)
    gattrs = dict(attrs, __fwd_type__=op_type)
    ctx = preg.EmitContext(torch.device("cpu"), amp=amp)
    want = preg.generic_vjp_grad_emitter(ctx, gins, gattrs)
    got = preg.lookup(op_type + "_grad").emitter(ctx, gins, gattrs)
    for slot in ("Input@GRAD", "Filter@GRAD"):
        w, g = want[slot][0], got[slot][0]
        assert g.dtype == w.dtype == torch.float32, slot
        assert g.shape == w.shape, slot
        tol = (2.0 ** -7 if amp else 1e-5) * w.abs().max().item()
        assert (g - w).abs().max().item() <= tol, slot


def _pool_attrs(**kw):
    attrs = {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1], "global_pooling": False, "ceil_mode": False,
             "exclusive": True}
    attrs.update(kw)
    return attrs


POOL = {
    "max_resnet": _pool_attrs(),
    "max_ceil": _pool_attrs(ceil_mode=True),
    "max_pad_eq_kernel": _pool_attrs(ksize=[2, 2], paddings=[2, 2],
                                     strides=[1, 1]),
    "max_pad_over_half": _pool_attrs(ksize=[3, 3], paddings=[2, 1],
                                     strides=[2, 3], ceil_mode=True),
    "avg_exclusive": _pool_attrs(pooling_type="avg"),
    "avg_exclusive_ceil": _pool_attrs(pooling_type="avg", ceil_mode=True),
    "avg_inclusive_ceil": _pool_attrs(pooling_type="avg", ceil_mode=True,
                                      exclusive=False),
    "avg_pad_eq_kernel": _pool_attrs(pooling_type="avg", ksize=[2, 2],
                                     paddings=[2, 2], strides=[1, 1]),
    "avg_no_pad": _pool_attrs(pooling_type="avg", ksize=[2, 3],
                              paddings=[0, 0], strides=[2, 2]),
    "global_avg": _pool_attrs(pooling_type="avg", global_pooling=True),
    "global_max": _pool_attrs(global_pooling=True),
    "adaptive_avg": _pool_attrs(pooling_type="avg", adaptive=True,
                                ksize=[3, 2]),
    "adaptive_max": _pool_attrs(adaptive=True, ksize=[4, 3]),
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", sorted(POOL))
def test_pool2d_matches_jax(name, fmt):
    x = f32(2, 3, 9, 7)  # odd sizes
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    _check(*_both("pool2d", {"X": [x]}, dict(POOL[name], data_format=fmt)))


def _jax_vjp(op_type, ins, attrs, out_slot, cot, wrt):
    info = jreg.lookup(op_type)

    def f(v):
        return info.emitter(jreg.EmitContext(),
                            dict(ins, **{wrt: [v]}), attrs)[out_slot][0]

    _, vjp = jax.vjp(f, ins[wrt][0])
    return np.asarray(vjp(cot)[0])


def _port_vjp(op_type, ins, attrs, out_slot, cot, wrt):
    info = preg.lookup(op_type)
    ctx = preg.EmitContext(torch.device("cpu"))

    def f(v):
        return info.emitter(ctx, dict(ins, **{wrt: [v]}), attrs)[out_slot][0]

    _, vjp = torch.func.vjp(f, ins[wrt][0])
    return vjp(cot)[0].numpy()


def test_max_pool_after_relu_routes_ties_alike():
    """After a ReLU whole windows are 0: both packages send a tied
    window's gradient to its first maximum, so the pool's input
    gradients agree exactly, and the relu's gradient then passes (half
    of) it only where the relu's input was 0 (jnp.maximum's tie rule,
    which the port's relu keeps)."""
    x = f32(2, 3, 8, 8)
    x[:, :, :4, :4] = -1.0   # windows of zeros after the relu
    x[:, :, 4:, 4:] = 0.0    # exact zeros at the relu's input
    attrs = _pool_attrs()
    r = np.maximum(x, 0)
    cot = f32(2, 3, 4, 4)
    jg = _jax_vjp("pool2d", {"X": [jnp.asarray(r)]}, attrs, "Out",
                  jnp.asarray(cot), "X")
    pg = _port_vjp("pool2d", {"X": [torch.from_numpy(r)]}, attrs, "Out",
                   torch.from_numpy(cot), "X")
    np.testing.assert_array_equal(pg, jg)
    assert (jg[:, :, :4, :4] != 0).any()  # ties do receive gradient
    jr = _jax_vjp("relu", {"X": [jnp.asarray(x)]}, {}, "Out",
                  jnp.asarray(jg), "X")
    pr = _port_vjp("relu", {"X": [torch.from_numpy(x)]}, {}, "Out",
                   torch.from_numpy(pg), "X")
    np.testing.assert_array_equal(pr, jr)
    assert (pr[:, :, 4:, 4:] == 0.5 * pg[:, :, 4:, 4:]).all()
    assert not pr[:, :, :4, :4].any()


def _bn_ins(shape, c_axis):
    c = shape[c_axis]
    return {"X": [f32(*shape) * 2 + 1], "Scale": [f32(c)], "Bias": [f32(c)],
            "Mean": [f32(c) * 0.1], "Variance": [np.abs(f32(c)) + 0.5]}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", ["train", "is_test", "use_global_stats"])
def test_batch_norm_matches_jax(mode, fmt, bf16):
    shape = (4, 5, 6, 3) if fmt == "NCHW" else (4, 6, 3, 5)
    ins = _bn_ins(shape, 1 if fmt == "NCHW" else 3)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "data_layout": fmt,
             "is_test": mode == "is_test",
             "use_global_stats": mode == "use_global_stats"}
    jouts, pouts = _both("batch_norm", ins, attrs,
                         bf16=("X",) if bf16 else ())
    _check(jouts, pouts)
    if mode == "train":
        # the running variance takes the biased batch variance, and
        # SavedVariance holds 1/sqrt(var + eps)
        xv = ins["X"][0].astype(np.float64)
        if bf16:
            xv = _np(torch.from_numpy(ins["X"][0]).to(torch.bfloat16))
        axes = (0, 2, 3) if fmt == "NCHW" else (0, 1, 2)
        var = xv.var(axis=axes)
        np.testing.assert_allclose(
            _np(pouts["VarianceOut"][0]),
            0.9 * ins["Variance"][0] + 0.1 * var, rtol=1e-4)
        np.testing.assert_allclose(_np(pouts["SavedVariance"][0]),
                                   1 / np.sqrt(var + 1e-5), rtol=1e-4)


@pytest.mark.parametrize("label_dtype", ["int32", "int64"])
@pytest.mark.parametrize("label_shape", [(6, 1), (6,)])
def test_cross_entropy_matches_jax(label_dtype, label_shape):
    probs = np.exp(f32(6, 10))
    probs /= probs.sum(-1, keepdims=True)
    probs[0, 3] = 0.0  # clipped to 1e-12 before the log
    label = RNG.randint(0, 10, label_shape).astype(label_dtype)
    label.reshape(-1)[0] = 3
    label.reshape(-1)[2] = -100
    _check(*_both("cross_entropy", {"X": [probs], "Label": [label]},
                  {"soft_label": False, "ignore_index": -100}))


def test_cross_entropy_soft_label_matches_jax():
    probs = np.abs(f32(4, 7)) + 0.1
    soft = np.abs(f32(4, 7))
    soft /= soft.sum(-1, keepdims=True)
    _check(*_both("cross_entropy", {"X": [probs], "Label": [soft]},
                  {"soft_label": True, "ignore_index": -100}))


def test_cross_entropy_grad_matches_jax():
    probs = np.exp(f32(5, 8))
    probs /= probs.sum(-1, keepdims=True)
    label = RNG.randint(0, 8, (5, 1)).astype(np.int64)
    label[1, 0] = -100
    attrs = {"soft_label": False, "ignore_index": -100}
    cot = f32(5, 1)
    jg = _jax_vjp("cross_entropy", {"X": [jnp.asarray(probs)],
                                    "Label": [jnp.asarray(label)]},
                  attrs, "Y", jnp.asarray(cot), "X")
    pg = _port_vjp("cross_entropy", {"X": [torch.from_numpy(probs)],
                                     "Label": [torch.from_numpy(label)]},
                   attrs, "Y", torch.from_numpy(cot), "X")
    np.testing.assert_allclose(pg, jg, rtol=1e-6, atol=1e-6)
    assert not pg[1].any()


@pytest.mark.parametrize("label_dtype", ["int32", "int64"])
@pytest.mark.parametrize("k", [1, 3])
def test_top_k_and_accuracy_match_jax(k, label_dtype):
    x = np.round(f32(7, 9), 1)  # ties, which both order by index
    x[2, :] = 0.5
    jouts, pouts = _both("top_k", {"X": [x]}, {"k": k})
    np.testing.assert_array_equal(pouts["Out"][0].numpy(),
                                  np.asarray(jouts["Out"][0]))
    np.testing.assert_array_equal(pouts["Indices"][0].numpy(),
                                  np.asarray(jouts["Indices"][0]))
    idx = pouts["Indices"][0].numpy()
    label = RNG.randint(0, 9, (7, 1)).astype(label_dtype)
    label[0, 0] = idx[0, 0]
    _check(*_both("accuracy", {"Out": [pouts["Out"][0].numpy()],
                               "Indices": [idx], "Label": [label]}, {}))


def test_mean_transpose_affine_channel_match_jax():
    _check(*_both("mean", {"X": [f32(3, 4, 5)]}, {}))
    _check(*_both("transpose", {"X": [f32(2, 3, 4, 5)]},
                  {"axis": [0, 2, 3, 1]}))
    _check(*_both("affine_channel", {"X": [f32(2, 3, 4, 5)],
                                     "Scale": [f32(3)], "Bias": [f32(3)]},
                  {}))


def test_transpose_output_is_dense():
    """The layout pass's transpose hands the spine channels-last memory,
    not a view of the NCHW storage."""
    out = preg.lookup("transpose").emitter(
        preg.EmitContext(torch.device("cpu")),
        {"X": [torch.from_numpy(f32(2, 3, 4, 5))]}, {"axis": [0, 2, 3, 1]})
    assert out["Out"][0].is_contiguous()


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_jax(nesterov):
    ins = {"Param": [f32(4, 3)], "Grad": [f32(4, 3)],
           "Velocity": [f32(4, 3)],
           "LearningRate": [np.array([0.1], np.float32)]}
    _check(*_both("momentum", ins, {"mu": 0.9, "use_nesterov": nesterov}))


@pytest.mark.parametrize("act", ["relu", "identity", "sigmoid"])
@pytest.mark.parametrize("residual", [False, True])
def test_conv2d_fusion_matches_jax(act, residual):
    ins = _conv_inputs(*CONV["stride_pad"])
    ins["Bias"] = [f32(6)]
    if residual:
        ins["ResidualData"] = [f32(2, 6, 5, 9)]
    _check(*_both("conv2d_fusion", ins,
                  dict(CONV["stride_pad"][2], activation=act)))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("with_bn", [False, True])
def test_fused_conv2d_matches_jax(with_bn, fmt):
    attrs = _conv_attrs(paddings=[1, 1], data_format=fmt,
                        conv_type="conv2d", activation="relu")
    ins = _conv_inputs((2, 4, 6, 5), (6, 4, 3, 3), attrs)
    ins["Bias"] = [f32(6)]
    if with_bn:
        attrs.update(with_bn=True, epsilon=1e-5)
        bn = _bn_ins((1, 6), 1)
        ins.update(Scale=bn["Scale"], BNBias=bn["Bias"], Mean=bn["Mean"],
                   Variance=bn["Variance"])
    _check(*_both("fused_conv2d", ins, attrs))


def test_flags_of_the_new_ops_match_jax():
    """no_grad, intermediate_outputs and whether a grad maker exists:
    they decide the grad descs append_backward writes."""
    for op_type in ("conv2d", "depthwise_conv2d", "pool2d", "batch_norm",
                    "cross_entropy", "accuracy", "top_k", "mean",
                    "transpose", "momentum", "fused_momentum",
                    "affine_channel", "conv2d_fusion", "fused_conv2d"):
        j, p = jreg.lookup(op_type), preg.lookup(op_type)
        assert p.no_grad == j.no_grad, op_type
        assert p.intermediate_outputs == j.intermediate_outputs, op_type
        assert (p.grad_maker is None) == (j.grad_maker is None), op_type

"""Each op emitter of the port's inference and training paths against the
JAX package's emitter on the same inputs and attrs (fp32 at atol 1e-6;
integer and mask outputs exact), the grad emitters (custom and the
generic vjp) against the JAX package's, plus the startup's random ops and
the host ops' tensor files."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import registry as jreg
from paddle_tpu.core.types import DataType as JDataType
from paddle_tpu.ops import kernels_host as jhost

import paddle_tpu_torch  # noqa: F401  (registers the emitters)
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.core.types import DataType
from paddle_tpu_torch.ops import kernels_host as phost

RNG = np.random.RandomState(0)


def f32(*shape):
    return RNG.randn(*shape).astype(np.float32)


def _run_both(op_type, ins, attrs, jattrs=None):
    """ins: slot -> list of numpy arrays. Returns (jax outs, port outs)
    as numpy, slot by slot."""
    jouts = jreg.lookup(op_type).emitter(
        jreg.EmitContext(), {s: [jnp.asarray(a) for a in v]
                             for s, v in ins.items()}, jattrs or attrs)
    pouts = preg.lookup(op_type).emitter(
        preg.EmitContext(torch.device("cpu")),
        {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}, attrs)
    return ({s: [np.asarray(v) for v in vs] for s, vs in jouts.items()},
            {s: [v.numpy() for v in vs] for s, vs in pouts.items()})


def _dt(name):
    """The same attr dtype in each package's enum."""
    return getattr(DataType, name), getattr(JDataType, name)


LN_X = f32(2, 5, 8)
CASES = {
    "mul_fc": ("mul", {"X": [f32(2, 5, 8)], "Y": [f32(8, 6)]},
               {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "mul_flatten": ("mul", {"X": [f32(3, 4, 5)], "Y": [f32(20, 7)]},
                    {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "reshape2_split_heads": ("reshape2", {"X": [f32(2, 5, 8)]},
                             {"shape": [-1, 5, 2, 4]}),
    "reshape2_zero_copy": ("reshape2", {"X": [f32(2, 5, 8)]},
                           {"shape": [0, 0, 4, -1]}),
    "transpose2": ("transpose2", {"X": [f32(2, 5, 2, 4)]},
                   {"axis": [0, 2, 1, 3]}),
    "elementwise_add_same": ("elementwise_add",
                             {"X": [f32(2, 5, 8)], "Y": [f32(2, 5, 8)]},
                             {"axis": -1}),
    "elementwise_add_bias_axis2": ("elementwise_add",
                                   {"X": [f32(2, 5, 8)], "Y": [f32(8)]},
                                   {"axis": 2}),
    "elementwise_add_mid_axis": ("elementwise_add",
                                 {"X": [f32(2, 5, 8)], "Y": [f32(5)]},
                                 {"axis": 1}),
    "layer_norm_last": ("layer_norm",
                        {"X": [LN_X], "Scale": [f32(8)], "Bias": [f32(8)]},
                        {"epsilon": 1e-5, "begin_norm_axis": 2}),
    "layer_norm_axis1_eps": ("layer_norm",
                             {"X": [LN_X], "Scale": [f32(40)],
                              "Bias": [f32(40)]},
                             {"epsilon": 1e-3, "begin_norm_axis": 1}),
    "scale_after": ("scale", {"X": [f32(3, 4)]},
                    {"scale": 1e9, "bias": -1e9, "bias_after_scale": True}),
    "scale_before": ("scale", {"X": [f32(3, 4)]},
                     {"scale": 0.5, "bias": 2.0, "bias_after_scale": False}),
    "relu": ("relu", {"X": [f32(4, 7)]}, {}),
    "elementwise_min": ("elementwise_min",
                        {"X": [f32(2, 5, 8)], "Y": [f32(8)]}, {"axis": -1}),
    "pow_neg_half": ("pow", {"X": [np.abs(f32(3, 4)) + 0.5]},
                     {"factor": -0.5}),
    "reduce_sum_all": ("reduce_sum", {"X": [f32(2, 5, 8)]},
                       {"dim": [], "keep_dim": False, "reduce_all": True}),
    "reduce_sum_dim_keep": ("reduce_sum", {"X": [f32(2, 5, 8)]},
                            {"dim": [1], "keep_dim": True,
                             "reduce_all": False}),
    "sum": ("sum", {"X": [f32(3, 4), f32(3, 4), f32(3, 4)]}, {}),
    "squeeze2": ("squeeze2", {"X": [f32(2, 5, 1)]}, {"axes": [2]}),
    "fill_zeros_like": ("fill_zeros_like", {"X": [f32(3, 4)]}, {}),
    "increment": ("increment", {"X": [np.array([3.0], np.float32)]},
                  {"step": 1.0}),
    "adam": ("adam", {"Param": [f32(4, 3)], "Grad": [f32(4, 3)],
                      "Moment1": [f32(4, 3) * 0.1],
                      "Moment2": [np.abs(f32(4, 3)) * 0.01],
                      "Beta1Pow": [np.array([0.9 ** 3], np.float32)],
                      "Beta2Pow": [np.array([0.98 ** 3], np.float32)],
                      "LearningRate": [np.array([0.01], np.float32)]},
             {"beta1": 0.9, "beta2": 0.98, "epsilon": 1e-9}),
    "softmax_with_cross_entropy": (
        "softmax_with_cross_entropy",
        {"Logits": [f32(2, 5, 10) * 3],
         "Label": [RNG.randint(0, 10, (2, 5, 1)).astype(np.int64)]},
        {"soft_label": False, "ignore_index": -100}),
    "softmax_with_cross_entropy_soft_label": (
        "softmax_with_cross_entropy",
        {"Logits": [f32(2, 5, 10)],
         "Label": [np.abs(f32(2, 5, 10)) / 10]},
        {"soft_label": True, "ignore_index": -100}),
    "softmax_with_cross_entropy_grad_soft_label": (
        "softmax_with_cross_entropy_grad",
        {"Logits": [f32(2, 5, 10)], "Label": [np.abs(f32(2, 5, 10)) / 10],
         "Loss@GRAD": [f32(2, 5, 1)]},
        {"soft_label": True, "ignore_index": -100}),
    "softmax_with_cross_entropy_grad": (
        "softmax_with_cross_entropy_grad",
        {"Logits": [f32(2, 5, 10) * 3],
         "Label": [np.where(RNG.rand(2, 5, 1) < 0.3, -100, RNG.randint(
             0, 10, (2, 5, 1))).astype(np.int64)],
         "Loss@GRAD": [f32(2, 5, 1)]},
        {"soft_label": False, "ignore_index": -100}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_float_emitter_matches_jax(name):
    op_type, ins, attrs = CASES[name]
    jouts, pouts = _run_both(op_type, ins, attrs)
    assert set(pouts) == set(jouts)
    for slot in jouts:
        for j, p in zip(jouts[slot], pouts[slot]):
            assert p.shape == j.shape, slot
            assert p.dtype == j.dtype, slot
            np.testing.assert_allclose(p, j, atol=1e-6, rtol=1e-6,
                                       err_msg=slot)


@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_lookup_table_matches_jax(padding_idx):
    w = f32(10, 6)
    ids = RNG.randint(0, 10, (2, 7, 1)).astype(np.int64)
    ids[0, :3, 0] = 3
    attrs = {"is_sparse": False, "is_distributed": False,
             "padding_idx": padding_idx}
    # the JAX executor narrows int64 ids to int32 at the feed; the port
    # keeps them int64
    jouts = jreg.lookup("lookup_table").emitter(
        jreg.EmitContext(), {"W": [jnp.asarray(w)],
                             "Ids": [jnp.asarray(ids.astype(np.int32))]},
        attrs)
    pouts = preg.lookup("lookup_table").emitter(
        preg.EmitContext(torch.device("cpu")),
        {"W": [torch.from_numpy(w)], "Ids": [torch.from_numpy(ids)]}, attrs)
    np.testing.assert_array_equal(pouts["Out"][0].numpy(),
                                  np.asarray(jouts["Out"][0]))
    assert pouts["Out"][0].shape == (2, 7, 6)


@pytest.mark.parametrize("out_dtype", ["int32", "float32"])
def test_sequence_mask_matches_jax(out_dtype):
    lens = np.array([0, 3, 8, 5], np.int32)
    jouts, pouts = _run_both("sequence_mask", {"X": [lens]},
                             {"maxlen": 8, "out_dtype": out_dtype})
    np.testing.assert_array_equal(pouts["Y"][0], jouts["Y"][0])
    assert pouts["Y"][0].dtype == np.dtype(out_dtype)


def test_cast_matches_jax():
    mask = (RNG.rand(3, 6) > 0.5).astype(np.int32)
    out_p, out_j = _dt("FP32")
    in_p, in_j = _dt("INT32")
    jouts, pouts = _run_both("cast", {"X": [mask]},
                             {"in_dtype": in_p, "out_dtype": out_p},
                             {"in_dtype": in_j, "out_dtype": out_j})
    np.testing.assert_array_equal(pouts["Out"][0], jouts["Out"][0])
    assert pouts["Out"][0].dtype == np.float32


@pytest.mark.parametrize("causal", [False, True], ids=["cross", "causal"])
def test_flash_attention_op_matches_jax(causal):
    q, k, v = f32(2, 2, 12, 8), f32(2, 2, 12, 8), f32(2, 2, 12, 8)
    kb = np.zeros((2, 12), np.float32)
    kb[1, 7:] = -1e9
    jouts, pouts = _run_both(
        "flash_attention", {"Q": [q], "K": [k], "V": [v], "KeyBias": [kb]},
        {"causal": causal, "scale": 8 ** -0.5})
    np.testing.assert_allclose(pouts["Out"][0], jouts["Out"][0], atol=1e-6)


def test_flash_attention_op_takes_strided_views():
    """transpose2 hands the op permuted views; the op makes them dense
    before the kernel's contiguity check."""
    q = torch.from_numpy(f32(2, 12, 2, 8)).permute(0, 2, 1, 3)
    assert not q.is_contiguous()
    out = preg.lookup("flash_attention").emitter(
        preg.EmitContext(torch.device("cpu")),
        {"Q": [q], "K": [q], "V": [q]}, {"causal": False, "scale": 0.3})
    ref = preg.lookup("flash_attention").emitter(
        preg.EmitContext(torch.device("cpu")),
        {"Q": [q.contiguous()], "K": [q.contiguous()], "V": [q.contiguous()]},
        {"causal": False, "scale": 0.3})
    assert torch.equal(out["Out"][0], ref["Out"][0])


@pytest.mark.parametrize("op_type", ["uniform_random", "gaussian_random",
                                     "fill_constant"])
def test_startup_ops_are_seeded_and_typed(op_type):
    attrs = {"shape": [64, 32], "dtype": DataType.FP32, "min": -0.5,
             "max": 0.5, "mean": 0.0, "std": 2.0, "value": 1.5, "seed": 0}

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        ctx = preg.EmitContext(torch.device("cpu"), generator=gen)
        return preg.lookup(op_type).emitter(ctx, {}, attrs)["Out"][0]

    a, b, c = draw(1), draw(1), draw(2)
    assert a.shape == (64, 32) and a.dtype == torch.float32
    assert torch.equal(a, b)
    if op_type == "uniform_random":
        assert not torch.equal(a, c)
        assert a.min() >= -0.5 and a.max() < 0.5
    elif op_type == "gaussian_random":
        assert not torch.equal(a, c)
        assert abs(a.std().item() - 2.0) < 0.2
    else:
        assert torch.all(a == 1.5)


def test_every_inference_op_has_an_emitter():
    for op_type in ("mul", "reshape2", "transpose2", "elementwise_add",
                    "layer_norm", "scale", "lookup_table", "flash_attention",
                    "sequence_mask", "cast", "relu", "fill_constant",
                    "uniform_random", "gaussian_random", "save", "load",
                    "save_combine", "load_combine"):
        assert preg.lookup(op_type).emitter is not None, op_type
    # the loss ops, which had shape rules only until the training slice
    for op_type in ("softmax_with_cross_entropy", "squeeze2", "reduce_sum"):
        info = preg.lookup(op_type)
        assert info.emitter is not None and info.infer_shape is not None


@pytest.mark.parametrize("direction", ["jax_writes", "port_writes"])
@pytest.mark.parametrize("dtype", ["float32", "int64", "bfloat16"])
def test_tensor_files_cross_load(tmp_path, direction, dtype):
    import ml_dtypes
    arr = f32(3, 4)
    if dtype == "bfloat16":
        np_arr = arr.astype(ml_dtypes.bfloat16)
        t = torch.from_numpy(arr).to(torch.bfloat16)
    else:
        np_arr = arr.astype(dtype) if dtype != "int64" else \
            RNG.randint(-9, 9, (3, 4)).astype(np.int64)
        t = torch.from_numpy(np_arr)
    path = str(tmp_path / "t")
    if direction == "jax_writes":
        jhost.save_tensor_to_file(path, np_arr)
        got = phost.load_tensor_from_file(path)
        assert torch.equal(got, t)
    else:
        phost.save_tensor_to_file(path, t)
        got = jhost.load_tensor_from_file(path)
        assert got.dtype == np_arr.dtype
        np.testing.assert_array_equal(got.astype(np.float32),
                                      np_arr.astype(np.float32))


@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_lookup_table_grad_matches_jax(padding_idx):
    """Dense scatter-add; repeated ids sum, padding rows get nothing."""
    w, og = f32(10, 6), f32(2, 7, 6)
    ids = RNG.randint(0, 10, (2, 7, 1)).astype(np.int64)
    ids[0, :3, 0] = 3
    ids[1, :4, 0] = 5
    attrs = {"is_sparse": False, "is_distributed": False,
             "padding_idx": padding_idx}
    jouts = jreg.lookup("lookup_table_grad").emitter(
        jreg.EmitContext(), {"W": [jnp.asarray(w)],
                             "Ids": [jnp.asarray(ids.astype(np.int32))],
                             "Out@GRAD": [jnp.asarray(og)]}, attrs)
    pouts = preg.lookup("lookup_table_grad").emitter(
        preg.EmitContext(torch.device("cpu")),
        {"W": [torch.from_numpy(w)], "Ids": [torch.from_numpy(ids)],
         "Out@GRAD": [torch.from_numpy(og)]}, attrs)
    np.testing.assert_allclose(pouts["W@GRAD"][0].numpy(),
                               np.asarray(jouts["W@GRAD"][0]), atol=1e-6)


def _generic_grad_both(fwd_type, ins, attrs, amp=False):
    """The generic vjp grad emitter of each package on one grad op."""
    attrs = dict(attrs, __fwd_type__=fwd_type)
    jouts = jreg.generic_vjp_grad_emitter(
        jreg.EmitContext(amp=amp),
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}, attrs)
    pouts = preg.generic_vjp_grad_emitter(
        preg.EmitContext(torch.device("cpu"), amp=amp),
        {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}, attrs)
    return jouts, pouts


GRAD_CASES = {
    "mul": ("mul", {"X": [f32(2, 5, 8)], "Y": [f32(8, 6)],
                    "Out@GRAD": [f32(2, 5, 6)]},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "layer_norm": ("layer_norm",
                   {"X": [LN_X], "Scale": [f32(8)], "Bias": [f32(8)],
                    "Y@GRAD": [f32(2, 5, 8)], "Mean": [f32(10)],
                    "Variance": [f32(10)]},
                   {"epsilon": 1e-5, "begin_norm_axis": 2}),
    "reshape2": ("reshape2", {"X": [f32(2, 5, 8)],
                              "Out@GRAD": [f32(2, 5, 2, 4)],
                              "XShape": [np.zeros((0, 2, 5, 8), np.float32)]},
                 {"shape": [0, 0, 2, 4]}),
    "elementwise_add_bias": ("elementwise_add",
                             {"X": [f32(2, 5, 8)], "Y": [f32(8)],
                              "Out@GRAD": [f32(2, 5, 8)]}, {"axis": 2}),
    "reduce_sum": ("reduce_sum", {"X": [f32(2, 5)], "Out@GRAD": [f32(1)]},
                   {"dim": [], "keep_dim": False, "reduce_all": True}),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_generic_vjp_grad_matches_jax(name):
    """The grad op re-runs the forward under torch.func.vjp (jax.vjp in
    the JAX package); saved intermediates (Mean, Variance, XShape) are
    inputs the vjp leaves alone."""
    fwd_type, ins, attrs = GRAD_CASES[name]
    jouts, pouts = _generic_grad_both(fwd_type, ins, attrs)
    assert set(pouts) == set(jouts)
    for slot in jouts:
        for j, p in zip(jouts[slot], pouts[slot]):
            assert p.dtype == torch.float32 and tuple(p.shape) == j.shape
            np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=2e-6,
                                       rtol=1e-5, err_msg=slot)


def test_generic_vjp_grad_under_amp_returns_input_dtypes():
    """Under AMP mul computes in bf16; its grads come back in the dtypes
    of the op's fp32 inputs, as jax.vjp through the bf16 cast gives."""
    x, y, g = f32(4, 8), f32(8, 6), f32(4, 6)
    jouts, pouts = _generic_grad_both(
        "mul", {"X": [x], "Y": [y], "Out@GRAD": [g]},
        {"x_num_col_dims": 1, "y_num_col_dims": 1}, amp=True)
    for slot in ("X@GRAD", "Y@GRAD"):
        j, p = np.asarray(jouts[slot][0]), pouts[slot][0]
        assert p.dtype == torch.float32 and j.dtype == np.float32
        np.testing.assert_allclose(p.numpy(), j, rtol=0,
                                   atol=2 ** -7 * np.abs(j).max())


def test_amp_elementwise_dtypes_match_jax():
    """Under AMP a bf16 activation plus an fp32 bias: the JAX package's
    emitter returns fp32 (its amp_harmonize never matches, see
    ops/kernels_math.py), and so does the port's; bf16 with bf16 stays
    bf16. The values agree exactly (one fp32 addition of the same
    numbers)."""
    import ml_dtypes
    act = f32(2, 5, 8).astype(ml_dtypes.bfloat16)
    bias = f32(8)
    cases = [(act, bias), (act, act.copy())]
    for xa, ya in cases:
        jout = jreg.lookup("elementwise_add").emitter(
            jreg.EmitContext(amp=True),
            {"X": [jnp.asarray(xa)], "Y": [jnp.asarray(ya)]}, {"axis": -1})
        pt_in = [torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16 if a.dtype == ml_dtypes.bfloat16 else
            torch.float32) for a in (xa, ya)]
        pout = preg.lookup("elementwise_add").emitter(
            preg.EmitContext(torch.device("cpu"), amp=True),
            {"X": [pt_in[0]], "Y": [pt_in[1]]}, {"axis": -1})
        j, p = np.asarray(jout["Out"][0]), pout["Out"][0]
        assert str(p.dtype).replace("torch.", "") == j.dtype.name
        np.testing.assert_array_equal(p.float().numpy(), j.astype(np.float32))


@pytest.mark.parametrize("causal", [False, True], ids=["cross", "causal"])
def test_flash_attention_grad_op_matches_jax(causal):
    """The port's custom grad emitter (forward recompute, then the
    backward) against the JAX package's generic vjp of flash_attention,
    KeyBias cotangent included."""
    q, k, v, g = (f32(2, 2, 12, 8) for _ in range(4))
    kb = np.zeros((2, 12), np.float32)
    kb[1, 7:] = -1e9
    ins = {"Q": [q], "K": [k], "V": [v], "KeyBias": [kb], "Out@GRAD": [g]}
    attrs = {"causal": causal, "scale": 8 ** -0.5,
             "__fwd_type__": "flash_attention"}
    jouts = jreg.generic_vjp_grad_emitter(
        jreg.EmitContext(), {s: [jnp.asarray(a) for a in v]
                             for s, v in ins.items()}, attrs)
    pouts = preg.lookup("flash_attention_grad").emitter(
        preg.EmitContext(torch.device("cpu")),
        {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}, attrs)
    assert set(pouts) == set(jouts)
    for slot in jouts:
        np.testing.assert_allclose(pouts[slot][0].numpy(),
                                   np.asarray(jouts[slot][0]), atol=2e-6,
                                   err_msg=slot)


def test_grad_flags_match_jax():
    """no_grad and intermediate_outputs decide the grad descs
    append_backward writes; the port's are the JAX package's."""
    for op_type in ("mul", "reshape2", "transpose2", "squeeze2",
                    "elementwise_add", "elementwise_mul", "elementwise_div",
                    "elementwise_min", "layer_norm", "scale", "lookup_table",
                    "flash_attention", "sequence_mask", "cast", "relu",
                    "fill_constant", "uniform_random", "gaussian_random",
                    "softmax_with_cross_entropy", "reduce_sum", "sum", "pow",
                    "increment", "adam", "lookup_table_grad",
                    "softmax_with_cross_entropy_grad", "fill_zeros_like"):
        j, p = jreg.lookup(op_type), preg.lookup(op_type)
        assert p.no_grad == j.no_grad, op_type
        assert p.intermediate_outputs == j.intermediate_outputs, op_type
        assert (p.grad_maker is None) == (j.grad_maker is None), op_type


def _no_device_copies(monkeypatch):
    """Make a copy of host data to another device raise: ``torch.tensor``
    or ``torch.as_tensor`` onto a device that is not the CPU, or
    ``Tensor.to`` from the CPU onto one. A CUDA graph capture does not
    permit such a copy (from pageable host memory). The emitters run on
    the meta device, which stands for the card here."""
    real_tensor, real_as, real_to = torch.tensor, torch.as_tensor, \
        torch.Tensor.to

    def off_host(device):
        return device is not None and torch.device(device).type != "cpu"

    def tensor(*args, device=None, **kwargs):
        if off_host(device):
            raise AssertionError(f"host data copied to {device} in a run")
        return real_tensor(*args, device=device, **kwargs)

    def as_tensor(*args, device=None, **kwargs):
        if off_host(device):
            raise AssertionError(f"host data copied to {device} in a run")
        return real_as(*args, device=device, **kwargs)

    def to(self, *args, **kwargs):
        out = real_to(self, *args, **kwargs)
        if self.device.type == "cpu" and out.device.type != "cpu":
            raise AssertionError(f"a CPU tensor moved to {out.device} in "
                                 "a run")
        return out

    monkeypatch.setattr(torch, "tensor", tensor)
    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    monkeypatch.setattr(torch.Tensor, "to", to)


@pytest.mark.parametrize("dtype,step", [
    ("float32", 1.0), ("float32", 0.1), ("int32", 2.0), ("int64", 1.0),
    ("int64", 1.5), ("bfloat16", 0.1)])
def test_increment_matches_jax_and_makes_no_host_tensor(dtype, step,
                                                         monkeypatch):
    """The step is cast to X's dtype as the JAX op casts it (1.5 -> 1 for
    integers, 0.1 rounded to bf16) and added as a Python number, with no
    copy of host data to the device (the run on the meta device). (The
    JAX package runs without x64, so its int64 counter is int32: values
    are compared.)"""
    x0 = np.array([3, -7], np.float32 if dtype == "bfloat16" else dtype)
    jx = jnp.asarray(x0).astype(jnp.bfloat16 if dtype == "bfloat16"
                                else x0.dtype)
    jout = jreg.lookup("increment").emitter(jreg.EmitContext(), {"X": [jx]},
                                            {"step": step})["Out"][0]
    px = torch.from_numpy(x0)
    if dtype == "bfloat16":
        px = px.to(torch.bfloat16)
    emit = preg.lookup("increment").emitter
    out = emit(preg.EmitContext(torch.device("cpu")), {"X": [px]},
               {"step": step})["Out"][0]
    meta = px.to("meta")
    _no_device_copies(monkeypatch)
    on_meta = emit(preg.EmitContext(meta.device), {"X": [meta]},
                   {"step": step})["Out"][0]
    monkeypatch.undo()
    assert out.dtype == on_meta.dtype == px.dtype
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jout).astype(np.float32))


@pytest.mark.parametrize("name,values,shape", [
    ("FP32", [0.5, -1.25, 3.0, 0.1, 7.0, -2.0], [2, 3]),
    ("INT32", [1, 2, -3], [3]), ("INT64", [4, 5], [2, 1])])
def test_assign_value_matches_jax_and_copies_its_literal_once(
        name, values, shape, monkeypatch):
    """Against the JAX emitter; with a plan's constants the literal is
    copied to the device at the first run only (the runs on the meta
    device), and each run gets a copy of its own (an in-place update of
    one run's output leaves the next run's alone)."""
    pdt, jdt = _dt(name)
    jout = jreg.lookup("assign_value").emitter(
        jreg.EmitContext(), {}, {"values": values, "shape": shape,
                                 "dtype": jdt})["Out"][0]
    attrs = {"values": values, "shape": shape, "dtype": pdt}
    ctx = preg.EmitContext(torch.device("cpu"), consts={})
    emit = preg.lookup("assign_value").emitter
    first = emit(ctx, {}, attrs)["Out"][0]
    first.add_(1)
    second = emit(ctx, {}, attrs)["Out"][0]
    meta_ctx = preg.EmitContext(torch.device("meta"), consts={})
    emit(meta_ctx, {}, attrs)
    _no_device_copies(monkeypatch)
    on_meta = emit(meta_ctx, {}, attrs)["Out"][0]
    with pytest.raises(AssertionError, match="moved to meta"):
        emit(preg.EmitContext(torch.device("meta")), {}, attrs)
    monkeypatch.undo()
    assert list(second.shape) == list(on_meta.shape) == shape
    assert on_meta.dtype == second.dtype
    assert second.dtype == {"FP32": torch.float32, "INT32": torch.int32,
                            "INT64": torch.int64}[name]
    np.testing.assert_array_equal(second.numpy(), np.asarray(jout))

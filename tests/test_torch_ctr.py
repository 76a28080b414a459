"""The CTR and similarity ops of the port -- ``auc``, ``log_loss`` and
``cos_sim`` -- and DeepFM, against the JAX package, on the CPU.

``log_loss`` and ``cos_sim`` (with Y broadcast as [1, D], and rows of
zeros) agree with the JAX ops in fp32, forward and through the generic
vjp against ``jax.vjp``, within 1e-6 relative (a zero row's gradient is
NaN in both, through sqrt at 0, and at the same places). ``auc`` over 8
streamed batches: the int64 stat buckets equal the JAX op's int32 ones
and the AUC agrees within 1e-6, while positives x negatives stay below
2^31.

Above it the two part, and the port is right: the JAX op keeps its
buckets in int32 (x64 is off) and multiplies counts in int32, so 60000
positives and 60000 negatives in separate buckets read 0.0 there, where
the port (int64 counts, float64 integration, as auc_op.h) reads 1.0
(ROADMAP C, reference caveats). A float64 numpy AUC of the port's stats
agrees with the port's within 1e-6.

DeepFM at vocab 1000 (5 fields, 3 dense, embed 4, tower 16-16), 3 steps
in both packages from the same weights, each on its own batch: the
losses within 1e-5 relative, the fetched AUC within 1e-6, the stat
buckets equal to the JAX package's and to a numpy recount of the labels
and the bucket of each fetched probability, and every parameter after
the third step within 1e-5 relative L2. From the JAX package's own
startup through ``io.set_params_from_numpy`` (its int32 stat buckets
widened to int64), one step agrees the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import registry as jreg
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.models import deepfm as pdeepfm
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

RTOL = 1e-6
NUM_THRESH = 4095


@pytest.fixture(autouse=True)
def _no_callstacks():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def port_op(op_type, ins, attrs):
    outs = preg.lookup(op_type).emitter(
        preg.EmitContext(torch.device("cpu")),
        {k: [torch.from_numpy(np.asarray(v))] for k, v in ins.items()}, attrs)
    return {k: v[0].numpy() for k, v in outs.items()}


def jax_op(op_type, ins, attrs):
    outs = jreg.lookup(op_type).emitter(
        jreg.EmitContext(), {k: [jnp.asarray(v)] for k, v in ins.items()},
        attrs)
    return {k: np.asarray(v[0]) for k, v in outs.items()}


def port_vjp(op_type, ins, attrs, out_slot, cot):
    """The port's generic grad op: {slot: grad} for the float inputs."""
    grad_ins = {k: [torch.from_numpy(np.asarray(v))] for k, v in ins.items()}
    grad_ins[out_slot + "@GRAD"] = [torch.from_numpy(cot)]
    outs = preg.generic_vjp_grad_emitter(
        preg.EmitContext(torch.device("cpu")), grad_ins,
        dict(attrs, __fwd_type__=op_type))
    return {k[:-len("@GRAD")]: v[0].numpy() for k, v in outs.items()
            if v[0] is not None}


def jax_vjp(op_type, ins, attrs, out_slot, cot, wrt):
    def f(*vals):
        full = {k: [jnp.asarray(v)] for k, v in ins.items()}
        for k, v in zip(wrt, vals):
            full[k] = [v]
        return jreg.lookup(op_type).emitter(jreg.EmitContext(), full,
                                            attrs)[out_slot][0]
    _, vjp = jax.vjp(f, *(jnp.asarray(ins[k]) for k in wrt))
    return {k: np.asarray(g) for k, g in zip(wrt, vjp(jnp.asarray(cot)))}


# ---------------------------------------------------------------------------
# log_loss and cos_sim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-4, 1e-7])
def test_log_loss_forward_and_vjp_match_jax(eps):
    rng = np.random.RandomState(0)
    ins = {"Predicted": rng.uniform(0.01, 0.99, (16, 1)).astype(np.float32),
           "Labels": rng.randint(0, 2, (16, 1)).astype(np.float32)}
    attrs = {"epsilon": eps}
    np.testing.assert_allclose(port_op("log_loss", ins, attrs)["Loss"],
                               jax_op("log_loss", ins, attrs)["Loss"],
                               rtol=RTOL, atol=0)
    cot = rng.randn(16, 1).astype(np.float32)
    got = port_vjp("log_loss", ins, attrs, "Loss", cot)
    want = jax_vjp("log_loss", ins, attrs, "Loss", cot,
                   ["Predicted", "Labels"])
    assert sorted(got) == ["Labels", "Predicted"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7)


def _cos_ins(broadcast, zero_rows):
    rng = np.random.RandomState(1)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randn(1 if broadcast else 8, 6).astype(np.float32)
    if zero_rows:
        x[2] = 0.0
        if not broadcast:
            y[5] = 0.0
    return {"X": x, "Y": y}


@pytest.mark.parametrize("zero_rows", [False, True], ids=["dense", "zeros"])
@pytest.mark.parametrize("broadcast", [False, True], ids=["rows", "bcast"])
def test_cos_sim_forward_and_vjp_match_jax(broadcast, zero_rows):
    ins = _cos_ins(broadcast, zero_rows)
    got, want = port_op("cos_sim", ins, {}), jax_op("cos_sim", ins, {})
    assert got["Out"].shape == (8, 1)
    assert got["YNorm"].shape == ((1, 1) if broadcast else (8, 1))
    for k in ("Out", "XNorm", "YNorm"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7)
    cot = np.random.RandomState(2).randn(8, 1).astype(np.float32)
    got = port_vjp("cos_sim", ins, {}, "Out", cot)
    want = jax_vjp("cos_sim", ins, {}, "Out", cot, ["X", "Y"])
    for k in ("X", "Y"):
        assert got[k].shape == ins[k].shape
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7)
    if zero_rows:
        assert np.isnan(got["X"][2]).all()


def test_cos_sim_grad_desc_matches_jax():
    """The grad maker writes the JAX package's cos_sim_grad: XNorm and
    YNorm go in as saved values, not as cotangents."""
    assert preg.lookup("cos_sim").intermediate_outputs == \
        jreg.lookup("cos_sim").intermediate_outputs == ("XNorm", "YNorm")
    assert preg.lookup("auc").no_grad and jreg.lookup("auc").no_grad


# ---------------------------------------------------------------------------
# auc
# ---------------------------------------------------------------------------

def _auc_batch(seed, n=256, two_col=True):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 2, (n, 1)).astype(np.int64)
    p = np.clip(rng.rand(n) * 0.6 + 0.4 * label[:, 0], 0.0, 1.0)
    p = p.astype(np.float32)
    pred = np.stack([1 - p, p], axis=1) if two_col else p.reshape(-1, 1)
    return pred, label


def numpy_auc(stat_pos, stat_neg):
    """A float64 trapezoid AUC of the stat buckets (auc_op.h)."""
    tp = np.cumsum(stat_pos[::-1].astype(np.float64))
    fp = np.cumsum(stat_neg[::-1].astype(np.float64))
    tp0 = np.concatenate([[0.0], tp[:-1]])
    fp0 = np.concatenate([[0.0], fp[:-1]])
    area = np.sum((fp - fp0) * (tp + tp0) / 2.0)
    denom = tp[-1] * fp[-1]
    return area / denom if denom > 0 else 0.0


@pytest.mark.parametrize("two_col", [True, False], ids=["2col", "1col"])
def test_auc_streamed_over_8_batches_matches_jax(two_col):
    attrs = {"curve": "ROC", "num_thresholds": NUM_THRESH}
    pstat = [np.zeros(NUM_THRESH + 1, np.int64) for _ in range(2)]
    jstat = [np.zeros(NUM_THRESH + 1, np.int32) for _ in range(2)]
    for step in range(8):
        pred, label = _auc_batch(step, two_col=two_col)
        got = port_op("auc", {"Predict": pred, "Label": label,
                              "StatPos": pstat[0], "StatNeg": pstat[1]},
                      attrs)
        want = jax_op("auc", {"Predict": pred, "Label": label,
                              "StatPos": jstat[0], "StatNeg": jstat[1]},
                      attrs)
        pstat = [got["StatPosOut"], got["StatNegOut"]]
        jstat = [want["StatPosOut"], want["StatNegOut"]]
        assert pstat[0].dtype == np.int64 and got["AUC"].dtype == np.float32
        for a, b in zip(pstat, jstat):
            np.testing.assert_array_equal(a, b.astype(np.int64))
        assert got["AUC"].shape == (1,)
        assert abs(got["AUC"][0] - want["AUC"][0]) <= 1e-6
        assert abs(got["AUC"][0] - numpy_auc(*pstat)) <= 1e-6
    assert pstat[0].sum() + pstat[1].sum() == 8 * 256
    assert 0.5 < got["AUC"][0] < 1.0


def test_auc_buckets_truncate_and_clip_as_jax():
    """p = 1.0 goes to the last bucket, p = 0 to the first, p below 0 is
    clipped; int32(p * 4095) truncates toward zero."""
    pred = np.array([0.0, 1.0, -0.5, 1.5, 0.5, 0.99999],
                    np.float32).reshape(-1, 1)
    label = np.array([[1], [0], [1], [0], [1], [1]], np.int64)
    z = np.zeros(NUM_THRESH + 1, np.int64)
    got = port_op("auc", {"Predict": pred, "Label": label, "StatPos": z,
                          "StatNeg": z}, {"num_thresholds": NUM_THRESH})
    want = jax_op("auc", {"Predict": pred, "Label": label,
                          "StatPos": z.astype(np.int32),
                          "StatNeg": z.astype(np.int32)},
                  {"num_thresholds": NUM_THRESH})
    for k in ("StatPosOut", "StatNegOut"):
        np.testing.assert_array_equal(got[k], want[k].astype(np.int64))
    assert got["StatPosOut"][[0, 2047, 4094]].tolist() == [2, 1, 1]
    assert got["StatNegOut"][4095] == 2


def test_auc_int32_overflow_in_the_jax_op():
    """The reference caveat (ROADMAP C): 60000 positives and 60000
    negatives, in two separate buckets, overflow the JAX op's int32
    products (3.6e9 > 2^31) and read AUC 0.0 there; the port reads 1.0.
    At 2000 of each both read 1.0."""
    attrs = {"num_thresholds": NUM_THRESH}
    for n, jax_reads in ((2000, 1.0), (60000, 0.0)):
        pred = np.concatenate([np.full(n, 0.9), np.full(n, 0.1)]).astype(
            np.float32).reshape(-1, 1)
        label = np.concatenate([np.ones(n), np.zeros(n)]).astype(
            np.int64).reshape(-1, 1)
        z = np.zeros(NUM_THRESH + 1, np.int64)
        got = port_op("auc", {"Predict": pred, "Label": label,
                              "StatPos": z, "StatNeg": z}, attrs)
        want = jax_op("auc", {"Predict": pred, "Label": label,
                              "StatPos": z.astype(np.int32),
                              "StatNeg": z.astype(np.int32)}, attrs)
        assert got["AUC"][0] == 1.0
        assert want["AUC"][0] == jax_reads
        assert numpy_auc(got["StatPosOut"], got["StatNegOut"]) == 1.0


# ---------------------------------------------------------------------------
# DeepFM, 3 steps
# ---------------------------------------------------------------------------

SMALL = dict(sparse_vocab=1000, num_fields=5, dense_dim=3, embed_dim=4,
             fc_sizes=(16, 16))


def test_deepfm_three_steps_match_jax():
    with junique.guard():
        j = jdeepfm.build(**SMALL)
    with punique.guard():
        p = pdeepfm.build(**SMALL)
    assert p["main"].desc.to_bytes() == j["main"].desc.to_bytes()
    pscope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    p["startup"].random_seed = 5
    exe.run(p["startup"], scope=pscope)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    for n in pscope.var_names():
        jscope.set_var(n, pscope.find_var(n).numpy().copy())
    auc_op = [o for o in p["main"].global_block().desc.ops
              if o.type == "auc"][0]
    stats = [auc_op.input("StatPos")[0], auc_op.input("StatNeg")[0]]
    assert pscope.find_var(stats[0]).dtype == torch.int64
    fetch = [p["loss"].name, p["auc"].name, p["predict"].name]
    recount = [np.zeros(NUM_THRESH + 1, np.int64) for _ in range(2)]
    for step in range(3):
        feed = pdeepfm.make_fake_batch(64, p["config"], seed=step)
        with fluid.scope_guard(jscope):
            jl, ja, _ = jexe.run(j["main"], feed=feed, fetch_list=fetch)
        pl, pa, prob = exe.run(p["main"], feed=feed, fetch_list=fetch,
                               scope=pscope)
        assert abs(pl[0] - jl[0]) <= 1e-5 * abs(jl[0])
        assert abs(pa[0] - ja[0]) <= 1e-6
        bucket = np.clip((prob.reshape(-1) * NUM_THRESH).astype(np.int32),
                         0, NUM_THRESH)
        pos = feed["click"].reshape(-1) > 0
        np.add.at(recount[0], bucket[pos], 1)
        np.add.at(recount[1], bucket[~pos], 1)
        for name, want in zip(stats, recount):
            got = pscope.find_var(name).numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, np.asarray(jscope.find_var(name)).astype(np.int64))
        assert abs(pa[0] - numpy_auc(*recount)) <= 1e-6
    for v in p["main"].all_parameters():
        want = np.asarray(jscope.find_var(v.name))
        got = pscope.find_var(v.name).numpy()
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), \
            v.name


def test_deepfm_from_the_jax_startup_through_set_params_from_numpy():
    """The JAX package's startup values reach the port through
    ``io.set_params_from_numpy``; its int32 stat buckets (x64 off) are
    widened to the program's int64. One step: the loss within 1e-5
    relative, the stats equal."""
    with junique.guard():
        j = jdeepfm.build(**SMALL)
    with punique.guard():
        p = pdeepfm.build(**SMALL)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    j["startup"].random_seed = 11
    with fluid.scope_guard(jscope):
        jexe.run(j["startup"])
    names = [v.name for v in p["main"].list_vars() if v.persistable]
    arrays = {n: np.asarray(jscope.find_var(n)) for n in names}
    assert any(a.dtype == np.int32 for a in arrays.values())
    pscope = pt.Scope()
    pt.io.set_params_from_numpy(pscope, arrays, "cpu", program=p["main"])
    auc_op = [o for o in p["main"].global_block().desc.ops
              if o.type == "auc"][0]
    stat = auc_op.input("StatPos")[0]
    assert pscope.find_var(stat).dtype == torch.int64
    feed = pdeepfm.make_fake_batch(32, p["config"], seed=4)
    with fluid.scope_guard(jscope):
        (jl,) = jexe.run(j["main"], feed=feed, fetch_list=[j["loss"]])
    (pl,) = pt.Executor(pt.CPUPlace()).run(
        p["main"], feed=feed, fetch_list=[p["loss"]], scope=pscope)
    assert abs(pl[0] - jl[0]) <= 1e-5 * abs(jl[0])
    np.testing.assert_array_equal(
        pscope.find_var(stat).numpy(),
        np.asarray(jscope.find_var(stat)).astype(np.int64))

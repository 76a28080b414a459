"""The image and NN op families of the port against the JAX package, on
the CPU.

- **Ops.** Each of the 36 types ``NEW_IMAGE_NN`` names (23 of
  ``paddle_tpu/ops/kernels_image.py``, 13 of ``kernels_nn.py``) runs
  through both packages' emitters on the same numpy-seeded inputs:
  integer and mask outputs equal, float outputs within FWD_REL of each
  output's largest magnitude (the convolutions, einsums and reductions
  sum in other orders; the rest agree bitwise). The four random types
  have checks of their own below.
- **Gradients.** Each gradful type's generic vjp against the JAX
  package's on the same cotangents, within GRAD_REL of each gradient's
  largest magnitude.
- **Ties.** After a ReLU whole windows tie at 0. ``jnp.max`` splits a
  window's gradient evenly among its tied maxima (maxout, spp, the
  adaptive pools, the ``*_with_index`` pools) and ``reduce_window`` max
  sends it to the first (pool3d): the port's gradients equal the JAX
  package's exactly there, and the masks take the first index in window
  order.
- **ceil_mode.** pool3d keeps the last window that starts in the
  padding, as the JAX op's extra high-side padding does (torch's own
  ceil mode drops it), and averages it over its unpadded count.
- **hash.** The JAX op's uint32 arithmetic, done in int64 with masks,
  equals a numpy uint32 reference; the JAX op itself raises for
  ``num_hash`` > 2 (its per-hash constant overflows uint32), the port
  wraps it.
- **Scatter-adds.** unpool over the indices of overlapping windows
  (repeated indices sum) and grid_sampler's gradient into X (many
  samples on one pixel) agree with the JAX package's.
- **The random types.** ``random_crop`` with the raw shape equal to the
  crop is the identity in both packages; at a larger raw shape each crop
  is an exact slice of its own image, its offsets inside the bounds and
  uniform (each offset's count within RAND_SIGMAS binomial deviations).
  ``sampling_id``'s draws follow the rows' probabilities; the
  ``*_batch_size_like`` draws have the batch, the bounds and the moments
  asked for.
- **AMP.** The transposed convolutions have no AMP cast point in the JAX
  package, whose ``lax`` convolution refuses a bf16 activation beside a
  float32 filter; the port promotes both to float32.
- **Descs.** One op of each of the 36 types, appended by hand, gives the
  same program bytes in both packages (the same infer rules).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import registry as jreg
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

from test_torch_tensor_ops import (_append, _pins, assert_close,
                                   assert_outputs_match, assert_vjp_match,
                                   run_both, vjp_both)

FWD_REL = 1e-5
GRAD_REL = 1e-5
RAND_SIGMAS = 5.0
MOMENT_TOL = 0.01

NEW_IMAGE = (
    "lrn", "crop", "pad_constant_like", "random_crop", "shuffle_channel",
    "space_to_depth", "max_pool2d_with_index", "unpool", "selu",
    "multiplex", "sampling_id", "norm", "data_norm",
    "bilinear_tensor_product", "mean_iou", "conv_shift", "fill", "reverse",
    "gaussian_random_batch_size_like", "grid_sampler", "affine_grid", "spp",
    "similarity_focus")
NEW_NN = (
    "conv2d_transpose", "huber_loss", "maxout", "prelu", "hash",
    "uniform_random_batch_size_like", "group_norm", "conv3d",
    "conv3d_transpose", "pool3d", "max_pool3d_with_index",
    "depthwise_conv2d_transpose", "precision_recall")
NEW_IMAGE_NN = NEW_IMAGE + NEW_NN
RANDOM = ("random_crop", "sampling_id", "gaussian_random_batch_size_like",
          "uniform_random_batch_size_like")


@pytest.fixture(autouse=True)
def _no_callstack():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


_R = np.random.RandomState(2020)


def _f(*shape, scale=1.0):
    return (_R.randn(*shape) * scale).astype(np.float32)


def _i(lo, hi, *shape, dtype=np.int64):
    return _R.randint(lo, hi, shape).astype(dtype)


# ---------------------------------------------------------------------------
# cases: (id, type, inputs, attrs)
# ---------------------------------------------------------------------------

def _pool3d(ptype, **kw):
    attrs = {"pooling_type": ptype, "ksize": [2, 3, 3], "strides": [2, 2, 2],
             "paddings": [1, 1, 0]}
    attrs.update(kw)
    return attrs


X5 = _f(2, 3, 5, 7, 6)
_IDX_SRC = _f(2, 3, 7, 7)
# unpool's inputs: a 3x3 stride-2 max pooling of a 7x7 plane, whose
# windows overlap, so some indices repeat
_POOLED = jreg.lookup("max_pool2d_with_index").emitter(
    jreg.EmitContext(), {"X": [jnp.asarray(_IDX_SRC)]},
    {"ksize": [3, 3], "strides": [2, 2], "paddings": [0, 0]})
UNPOOL_X = np.asarray(_POOLED["Out"][0])
UNPOOL_IDX = np.asarray(_POOLED["Mask"][0])

CASES = [
    # kernels_nn
    ("conv2d_transpose", "conv2d_transpose",
     {"Input": [_f(2, 4, 5, 5)], "Filter": [_f(4, 3, 4, 4)]},
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 1}),
    ("conv2d_transpose_grouped_dilated", "conv2d_transpose",
     {"Input": [_f(2, 4, 5, 6)], "Filter": [_f(4, 3, 3, 3)]},
     {"strides": [2, 1], "paddings": [0, 1], "dilations": [2, 2],
      "groups": 2}),
    ("depthwise_conv2d_transpose", "depthwise_conv2d_transpose",
     {"Input": [_f(2, 3, 4, 4)], "Filter": [_f(3, 1, 3, 3)]},
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}),
    ("conv3d", "conv3d", {"Input": [X5], "Filter": [_f(4, 3, 3, 3, 3)]},
     {"strides": [1, 2, 2], "paddings": [1, 1, 1], "dilations": [1, 1, 1],
      "groups": 1}),
    ("conv3d_grouped", "conv3d",
     {"Input": [_f(2, 4, 4, 5, 5)], "Filter": [_f(6, 2, 2, 3, 3)]},
     {"strides": [1, 1, 1], "paddings": [0, 1, 1], "dilations": [1, 2, 1],
      "groups": 2}),
    ("conv3d_transpose", "conv3d_transpose",
     {"Input": [_f(2, 4, 3, 4, 4)], "Filter": [_f(4, 2, 3, 3, 3)]},
     {"strides": [2, 2, 2], "paddings": [1, 1, 1], "dilations": [1, 1, 1],
      "groups": 1}),
    ("pool3d_max", "pool3d", {"X": [X5]}, _pool3d("max")),
    ("pool3d_avg", "pool3d", {"X": [X5]}, _pool3d("avg")),
    ("pool3d_avg_inclusive", "pool3d", {"X": [X5]},
     _pool3d("avg", exclusive=False)),
    ("pool3d_max_ceil", "pool3d", {"X": [X5]},
     _pool3d("max", ceil_mode=True)),
    ("pool3d_avg_ceil", "pool3d", {"X": [X5]},
     _pool3d("avg", ceil_mode=True)),
    ("pool3d_global_max", "pool3d", {"X": [X5]},
     _pool3d("max", global_pooling=True)),
    ("pool3d_global_avg", "pool3d", {"X": [X5]},
     _pool3d("avg", global_pooling=True)),
    ("pool3d_adaptive_max", "pool3d", {"X": [X5]},
     {"pooling_type": "max", "ksize": [2, 3, 4], "adaptive": True}),
    ("pool3d_adaptive_avg", "pool3d", {"X": [X5]},
     {"pooling_type": "avg", "ksize": [3, 2, 4], "adaptive": True}),
    ("max_pool3d_with_index", "max_pool3d_with_index", {"X": [X5]},
     {"ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [0, 0, 0]}),
    ("max_pool3d_with_index_overlap", "max_pool3d_with_index",
     {"X": [X5 - 1.0]},
     {"ksize": [3, 3, 3], "strides": [2, 2, 2], "paddings": [1, 1, 1]}),
    ("group_norm", "group_norm",
     {"X": [_f(2, 6, 4, 5) * 2 + 1], "Scale": [_f(6)], "Bias": [_f(6)]},
     {"groups": 3, "epsilon": 1e-5}),
    ("group_norm_plain", "group_norm", {"X": [_f(3, 4, 5)]},
     {"groups": 2, "epsilon": 1e-3}),
    ("prelu_all", "prelu", {"X": [_f(2, 3, 4, 4)], "Alpha": [_f(1)]},
     {"mode": "all"}),
    ("prelu_channel", "prelu",
     {"X": [_f(2, 3, 4, 4)], "Alpha": [_f(1, 3, 1, 1)]}, {"mode": "channel"}),
    ("prelu_element", "prelu",
     {"X": [_f(2, 3, 4, 4)], "Alpha": [_f(1, 3, 4, 4)]}, {"mode": "element"}),
    ("maxout", "maxout", {"X": [_f(2, 6, 3, 4)]}, {"groups": 2}),
    ("huber_loss", "huber_loss", {"X": [_f(8, 1) * 2], "Y": [_f(8, 1) * 2]},
     {"delta": 1.0}),
    ("hash", "hash", {"X": [_i(-50, 10 ** 6, 6, 1)]},
     {"num_hash": 1, "mod_by": 1000}),
    ("hash_two", "hash", {"X": [_i(0, 2 ** 31, 5, 2)]},
     {"num_hash": 2, "mod_by": 97}),
    ("precision_recall", "precision_recall",
     {"Indices": [_i(0, 4, 12, 1, dtype=np.int32)],
      "Labels": [_i(0, 4, 12, 1, dtype=np.int32)]},
     {"class_number": 4}),
    ("precision_recall_weighted", "precision_recall",
     {"Indices": [_i(0, 5, 12, 1)], "Labels": [_i(0, 5, 12, 1)],
      "Weights": [np.abs(_f(12, 1))],
      "StatesInfo": [np.abs(_f(5, 4)) * 3]},
     {"class_number": 5}),
    # kernels_image
    ("lrn", "lrn", {"X": [_f(2, 7, 3, 3)]},
     {"n": 5, "k": 2.0, "alpha": 0.1, "beta": 0.75}),
    ("crop", "crop", {"X": [_f(3, 5, 6)]},
     {"shape": [2, 3, 4], "offsets": [1, 1, 2]}),
    ("crop_like", "crop", {"X": [_f(3, 5, 6)], "Y": [_f(2, 4, 3)]},
     {"offsets": [0, 1, 3]}),
    ("pad_constant_like", "pad_constant_like",
     {"X": [_f(4, 5, 6)], "Y": [_f(2, 3, 6)]}, {"pad_value": 1.5}),
    ("shuffle_channel", "shuffle_channel", {"X": [_f(2, 6, 3, 3)]},
     {"group": 3}),
    ("space_to_depth", "space_to_depth", {"X": [_f(2, 3, 4, 6)]},
     {"blocksize": 2}),
    ("max_pool2d_with_index", "max_pool2d_with_index",
     {"X": [_f(2, 3, 7, 7) - 2.0]},
     {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
    ("unpool", "unpool", {"X": [UNPOOL_X], "Indices": [UNPOOL_IDX]},
     {"unpooled_height": 7, "unpooled_width": 7}),
    ("selu", "selu", {"X": [_f(3, 4)]}, {}),
    ("selu_attrs", "selu", {"X": [_f(3, 4)]}, {"scale": 1.2, "alpha": 0.5}),
    ("multiplex", "multiplex",
     {"X": [_f(4, 5), _f(4, 5), _f(4, 5)],
      "Ids": [np.array([[2], [0], [1], [2]], np.int32)]}, {}),
    ("norm", "norm", {"X": [_f(3, 4, 5)]}, {"axis": 1, "epsilon": 1e-10}),
    ("data_norm", "data_norm",
     {"X": [_f(4, 5)], "BatchSize": [np.abs(_f(5)) * 10 + 1],
      "BatchSum": [_f(5) * 3], "BatchSquareSum": [np.abs(_f(5)) * 10 + 1]},
     {}),
    ("bilinear_tensor_product", "bilinear_tensor_product",
     {"X": [_f(4, 3)], "Y": [_f(4, 5)], "Weight": [_f(6, 3, 5)],
      "Bias": [_f(1, 6)]}, {}),
    ("mean_iou", "mean_iou",
     {"Predictions": [_i(0, 5, 20, dtype=np.int32)],
      "Labels": [_i(0, 4, 20, dtype=np.int32)]}, {"num_classes": 6}),
    ("conv_shift", "conv_shift", {"X": [_f(3, 7)], "Y": [_f(3, 3)]}, {}),
    ("fill", "fill", {}, {"shape": [2, 3], "value": [1.5, -2, 3, 0.25, 5, 6],
                          "dtype": "float32"}),
    ("fill_int", "fill", {}, {"shape": [3], "value": [4, 7, -1],
                              "dtype": "int32"}),
    ("reverse", "reverse", {"X": [_f(3, 4, 5)]}, {"axis": [0, 2]}),
    ("reverse_int_axis", "reverse", {"X": [_f(3, 4, 5)]}, {"axis": 1}),
    ("grid_sampler", "grid_sampler",
     {"X": [_f(2, 3, 5, 6)],
      "Grid": [_R.uniform(-1.2, 1.2, (2, 4, 4, 2)).astype(np.float32)]}, {}),
    ("affine_grid", "affine_grid", {"Theta": [_f(2, 2, 3)]},
     {"output_shape": [2, 3, 4, 5]}),
    ("spp_max", "spp", {"X": [_f(2, 3, 5, 7) - 3.0]},
     {"pyramid_height": 3, "pooling_type": "max"}),
    ("spp_avg", "spp", {"X": [_f(2, 3, 5, 7)]},
     {"pyramid_height": 3, "pooling_type": "avg"}),
    ("similarity_focus", "similarity_focus", {"X": [_f(2, 3, 4, 5)]},
     {"axis": 1, "indexes": [0, 2]}),
    ("similarity_focus_axis2", "similarity_focus", {"X": [_f(2, 3, 4, 5)]},
     {"axis": 2, "indexes": [1]}),
]

DETERMINISTIC = set(NEW_IMAGE_NN) - set(RANDOM)
GRADFUL = sorted(t for t in DETERMINISTIC if not jreg.lookup(t).no_grad)


def test_cases_cover_the_36_types():
    assert len(NEW_IMAGE_NN) == 36 and len(set(NEW_IMAGE_NN)) == 36
    assert {c[1] for c in CASES} == DETERMINISTIC
    assert len(GRADFUL) == 26
    for t in NEW_IMAGE_NN:
        assert preg.lookup(t).emitter is not None, t
        for flag in ("no_grad", "intermediate_outputs", "needs_rng",
                     "is_host"):
            assert getattr(preg.lookup(t), flag) == getattr(
                jreg.lookup(t), flag), (t, flag)
    # the registry flags the issue names
    assert preg.lookup("data_norm").no_grad
    assert all(preg.lookup(t).needs_rng for t in RANDOM)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_vision_op_matches_jax(case):
    _, op_type, ins, attrs = case
    j, p = run_both(op_type, ins, attrs)
    assert sorted(p) == sorted(j)
    assert_outputs_match(j, p, rel=FWD_REL)


GRAD_CASES = [c for c in CASES if c[1] in GRADFUL]


def test_every_gradful_type_has_a_vjp_case():
    assert {c[1] for c in GRAD_CASES} == set(GRADFUL)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_vision_op_vjp_matches_jax(case):
    _, op_type, ins, attrs = case
    assert_vjp_match(op_type, ins, attrs, rel=GRAD_REL)


# ---------------------------------------------------------------------------
# ties after a ReLU
# ---------------------------------------------------------------------------

def _relu_ties(*shape):
    """A ReLU's output with whole windows at 0 and some exact repeats."""
    v = np.maximum(_f(*shape), 0.0)
    v[..., :3, :3] = 0.0
    v[..., -1, -1] = v[..., -1, -2]
    return v


TIE_CASES = [
    ("maxout", {"X": [_relu_ties(2, 6, 4, 4)]}, {"groups": 3}),
    ("spp", {"X": [_relu_ties(2, 2, 5, 6)]},
     {"pyramid_height": 2, "pooling_type": "max"}),
    ("pool2d", {"X": [_relu_ties(2, 2, 6, 6)]},
     {"pooling_type": "max", "ksize": [4, 3], "adaptive": True}),
    ("pool3d", {"X": [_relu_ties(2, 2, 3, 6, 6)]},
     {"pooling_type": "max", "ksize": [2, 3, 4], "adaptive": True}),
    ("pool3d", {"X": [_relu_ties(2, 2, 3, 6, 6)]},
     {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2],
      "paddings": [1, 0, 0]}),
    ("max_pool2d_with_index", {"X": [_relu_ties(2, 2, 6, 6)]},
     {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
    ("max_pool3d_with_index", {"X": [_relu_ties(2, 2, 4, 6, 6)]},
     {"ksize": [2, 3, 3], "strides": [2, 2, 2], "paddings": [0, 1, 1]}),
]


@pytest.mark.parametrize("case", TIE_CASES,
                         ids=[f"{c[0]}_{i}" for i, c in enumerate(TIE_CASES)])
def test_tied_maxima_route_the_gradient_alike(case):
    """Windows of zeros after a ReLU: the forward and the masks (the
    first index in window order) equal the JAX package's exactly, and the
    input gradient reaches the ties as the JAX op sends it (evenly for
    ``jnp.max``, to the first for ``reduce_window``) within GRAD_REL: a
    share of a split and the sums over overlapping windows may round an
    ulp apart."""
    op_type, ins, attrs = case
    j, p = run_both(op_type, ins, attrs)
    for slot in j:
        for want, got in zip(j[slot], p[slot]):
            np.testing.assert_array_equal(got, want.astype(got.dtype))
    jg, pg = vjp_both(op_type, ins, attrs, seed=7)
    want = np.asarray(jg["X@GRAD"][0])
    assert_close(pg["X@GRAD"][0].numpy(), want, GRAD_REL, op_type)
    assert (want[..., :3, :3] != 0).any()


def test_even_split_among_ties():
    """maxout of four equal channels passes a quarter of the cotangent to
    each (jnp.max's rule, which ``amax`` keeps)."""
    ins = {"X": [np.zeros((1, 4, 1, 1), np.float32)]}
    jg, pg = vjp_both("maxout", ins, {"groups": 4}, seed=3)
    g = pg["X@GRAD"][0].numpy().reshape(-1)
    assert np.all(g == g[0]) and g[0] != 0
    np.testing.assert_array_equal(g, np.asarray(jg["X@GRAD"][0]).reshape(-1))


def test_with_index_masks_take_the_first_maximum():
    xv = np.zeros((1, 1, 4, 4), np.float32)
    xv[0, 0, 1, 1] = xv[0, 0, 1, 0] = 2.0
    _, p = run_both("max_pool2d_with_index", {"X": [xv]},
                    {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]})
    assert p["Mask"][0].dtype == np.int32
    assert p["Mask"][0].tolist() == [[[[4, 2], [8, 10]]]]


# ---------------------------------------------------------------------------
# ceil_mode, hash, the scatter-adds
# ---------------------------------------------------------------------------

def test_pool3d_ceil_mode_keeps_the_window_in_the_padding():
    """Size 5, kernel 2, stride 2, padding 1: the JAX op's ceil formula
    gives 4 windows a dim, the last starting at padded index 6, past the
    input; torch's own ceil mode drops it and gives 3. That window holds
    padding only: its max is -inf, its exclusive average 0 / 0 (NaN) and
    its inclusive one 0, in both packages."""
    xv = _f(1, 2, 5, 5, 5)
    attrs = {"pooling_type": "avg", "ksize": [2, 2, 2],
             "strides": [2, 2, 2], "paddings": [1, 1, 1], "ceil_mode": True}
    lib = torch.nn.functional.avg_pool3d(torch.from_numpy(xv), 2, 2, 1,
                                         ceil_mode=True)
    assert lib.shape[2:] == (3, 3, 3)
    for kw, last in (({}, np.nan), ({"exclusive": False}, 0.0),
                     ({"pooling_type": "max"}, -np.inf)):
        j, p = run_both("pool3d", {"X": [xv]}, dict(attrs, **kw))
        out = p["Out"][0]
        assert out.shape == (1, 2, 4, 4, 4)
        assert_outputs_match(j, p, rel=FWD_REL)
        np.testing.assert_array_equal(out[:, :, 3, 3, 3], np.full((1, 2), last))


def _numpy_hash(xv, num_hash, mod):
    u = xv.astype(np.int64).astype(np.uint32)
    outs = []
    with np.errstate(over="ignore"):
        for i in range(num_hash):
            h = u * np.uint32(2654435761) + np.uint32(
                (i * 0x9E3779B9) & 0xFFFFFFFF)
            h = h ^ (h >> np.uint32(16))
            outs.append((h % np.uint32(mod)).astype(np.int64))
    return np.stack(outs, -1) if num_hash > 1 else outs[0]


@pytest.mark.parametrize("num_hash", [1, 2, 4])
def test_hash_is_uint32_arithmetic(num_hash):
    xv = np.concatenate([_i(-2 ** 31, 2 ** 31, 9, 1),
                         np.array([[0], [-1], [2 ** 31 - 1]], np.int64)])
    attrs = {"num_hash": num_hash, "mod_by": 100003}
    got = preg.lookup("hash").emitter(
        preg.EmitContext(torch.device("cpu")),
        {"X": [torch.from_numpy(xv)]}, attrs)["Out"][0]
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  _numpy_hash(xv, num_hash, 100003))
    if num_hash > 2:
        with pytest.raises(OverflowError):
            jreg.lookup("hash").emitter(jreg.EmitContext(),
                                        {"X": [jnp.asarray(xv)]}, attrs)
    else:
        j, p = run_both("hash", {"X": [xv]}, attrs)
        assert_outputs_match(j, p)


def test_unpool_sums_repeated_indices():
    flat = UNPOOL_IDX.reshape(2, 3, -1)
    assert any(len(np.unique(r)) < r.size for r in flat.reshape(6, -1))
    j, p = run_both("unpool", {"X": [UNPOOL_X], "Indices": [UNPOOL_IDX]},
                    {"unpooled_height": 7, "unpooled_width": 7})
    want = np.zeros((2, 3, 49), np.float32)
    for b in range(2):
        for c in range(3):
            np.add.at(want[b, c], flat[b, c], UNPOOL_X[b, c].reshape(-1))
    np.testing.assert_allclose(p["Out"][0].reshape(2, 3, 49), want,
                               rtol=0, atol=1e-6)
    assert_outputs_match(j, p, rel=FWD_REL)


def test_grid_sampler_gradient_scatters_alike():
    """A grid that samples a 3x3 map 64 times: every pixel receives many
    bilinear weights, the gradient into X is their scatter-add."""
    ins = {"X": [_f(2, 2, 3, 3)],
           "Grid": [_R.uniform(-1.0, 1.0, (2, 8, 8, 2)).astype(np.float32)]}
    assert_vjp_match("grid_sampler", ins, {}, rel=GRAD_REL)


def test_similarity_focus_ties_take_the_first_in_flat_order():
    xv = np.zeros((1, 1, 3, 3), np.float32)
    xv[0, 0, 0, 2] = xv[0, 0, 1, 0] = 5.0
    j, p = run_both("similarity_focus", {"X": [xv]},
                    {"axis": 1, "indexes": [0]})
    assert_outputs_match(j, p, rel=0.0)
    assert p["Out"][0][0, 0].tolist() == [[0, 0, 1], [1, 0, 0], [0, 1, 0]]


# ---------------------------------------------------------------------------
# the random types
# ---------------------------------------------------------------------------

def _port(op_type, ins, attrs, seed=0):
    return preg.lookup(op_type).emitter(
        preg.EmitContext(torch.device("cpu"),
                         generator=torch.Generator().manual_seed(seed)),
        _pins(ins), attrs)


def test_random_crop_at_the_crop_shape_is_the_identity():
    """Raw shape equal to the crop: the one offset is 0 in both packages,
    so both crops are the input."""
    raw = _R.randint(0, 256, (3, 6, 5, 3)).astype(np.uint8)
    j, p = run_both("random_crop", {"X": [raw]}, {"shape": [6, 5, 3]})
    np.testing.assert_array_equal(p["Out"][0], raw)
    np.testing.assert_array_equal(j["Out"][0], raw)
    assert p["SeedOut"][0].tolist() == [0]


def test_random_crop_slices_each_image_at_uniform_offsets():
    """Each crop equals its own image at some offset inside the bounds;
    the offsets of 4000 crops of one dim fall on each of its 5 values
    within RAND_SIGMAS binomial deviations of n / 5, and the examples of
    one batch get different offsets."""
    n, h, w = 4000, 8, 3
    raw = np.arange(n * h * w, dtype=np.float32).reshape(n, h, w)
    out = _port("random_crop", {"X": [raw]}, {"shape": [4, 3]},
                seed=5)["Out"][0].numpy()
    assert out.shape == (n, 4, 3)
    off = (out[:, 0, 0] - raw[:, 0, 0]) / w
    assert np.all(off == np.round(off)) and off.min() >= 0 and off.max() <= 4
    off = off.astype(int)
    for b in range(0, n, 97):
        np.testing.assert_array_equal(out[b], raw[b, off[b]:off[b] + 4])
    counts = np.bincount(off, minlength=5)
    sd = np.sqrt(n * 0.2 * 0.8)
    assert np.all(np.abs(counts - n / 5) <= RAND_SIGMAS * sd), counts
    # no leading dim: one crop of the whole input
    one = _port("random_crop", {"X": [raw[0]]}, {"shape": [5, 2]})
    o = one["Out"][0].numpy()
    assert o.shape == (5, 2)
    r0, c0 = divmod(int(o[0, 0]), w)
    np.testing.assert_array_equal(o, raw[0, r0:r0 + 5, c0:c0 + 2])


def test_sampling_id_follows_the_probabilities():
    probs = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    x = np.tile(probs, (20000, 1))
    out = _port("sampling_id", {"X": [x]}, {"seed": 0})["Out"][0].numpy()
    assert out.dtype == np.int64 and out.shape == (20000,)
    counts = np.bincount(out, minlength=4)
    assert counts[1] == 0
    sd = np.sqrt(20000 * probs * (1 - probs))
    assert np.all(np.abs(counts - 20000 * probs) <= RAND_SIGMAS * sd + 1e-9)
    j = jreg.lookup("sampling_id").emitter(
        jreg.EmitContext(rng=jax.random.PRNGKey(0)),
        {"X": [jnp.asarray(x[:2000])]}, {})["Out"][0]
    assert np.asarray(j).shape == (2000,) and 1 not in np.asarray(j)


@pytest.mark.parametrize("op_type", ["uniform_random_batch_size_like",
                                     "gaussian_random_batch_size_like"])
def test_batch_size_like_draws(op_type):
    """Input's dim 1 sets dim 0 of the draw; uniform within [min, max)
    with the uniform's mean and deviation, normal with ``mean`` and
    ``std``, within MOMENT_TOL of the scale, in both packages."""
    ref = np.zeros((3, 500), np.float32)
    attrs = {"shape": [-1, 400], "input_dim_idx": 1, "output_dim_idx": 0}
    if op_type.startswith("uniform"):
        attrs.update({"min": -2.0, "max": 4.0})
        mean, sd, scale = 1.0, 6.0 / np.sqrt(12.0), 6.0
    else:
        attrs.update({"mean": 1.5, "std": 2.0, "dtype": "float32"})
        mean, sd, scale = 1.5, 2.0, 2.0
    jout = np.asarray(jreg.lookup(op_type).emitter(
        jreg.EmitContext(rng=jax.random.PRNGKey(1)),
        {"Input": [jnp.asarray(ref)]}, attrs)["Out"][0])
    pout = _port(op_type, {"Input": [ref]}, attrs)["Out"][0].numpy()
    for got in (jout, pout):
        assert got.shape == (500, 400) and got.dtype == np.float32
        if op_type.startswith("uniform"):
            assert got.min() >= -2.0 and got.max() < 4.0
        assert abs(got.mean() - mean) <= MOMENT_TOL * scale
        assert abs(got.std() - sd) <= MOMENT_TOL * scale


# ---------------------------------------------------------------------------
# AMP: the transposed convolutions promote their operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op_type,xs,ws,attrs", [
    ("conv2d_transpose", (2, 4, 5, 5), (4, 3, 4, 4),
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 1}),
    ("conv3d_transpose", (1, 4, 3, 4, 4), (4, 2, 3, 3, 3),
     {"strides": [2, 2, 2], "paddings": [1, 1, 1], "dilations": [1, 1, 1],
      "groups": 1})])
def test_transposed_conv_promotes_a_bf16_activation(op_type, xs, ws, attrs):
    """Under AMP a bf16 activation meets the float32 filter: the JAX op's
    ``lax`` product refuses the pair, the port runs it in float32 on the
    activation's values, equal to the float32 op on them."""
    xv = torch.from_numpy(_f(*xs)).to(torch.bfloat16)
    wv = torch.from_numpy(_f(*ws))
    ctx = preg.EmitContext(torch.device("cpu"), amp=True)
    got = preg.lookup(op_type).emitter(
        ctx, {"Input": [xv], "Filter": [wv]}, attrs)["Output"][0]
    want = preg.lookup(op_type).emitter(
        preg.EmitContext(torch.device("cpu")),
        {"Input": [xv.float()], "Filter": [wv]}, attrs)["Output"][0]
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="same dtypes"):
        jreg.lookup(op_type).emitter(
            jreg.EmitContext(amp=True),
            {"Input": [jnp.asarray(xv.float().numpy(), jnp.bfloat16)],
             "Filter": [jnp.asarray(wv.numpy())]}, attrs)


def test_conv3d_casts_under_amp():
    ctx = preg.EmitContext(torch.device("cpu"), amp=True)
    out = preg.lookup("conv3d").emitter(
        ctx, {"Input": [torch.from_numpy(X5)],
              "Filter": [torch.from_numpy(_f(2, 3, 1, 1, 1))]},
        {"strides": [1, 1, 1], "paddings": [0, 0, 0],
         "dilations": [1, 1, 1], "groups": 1})["Output"][0]
    assert out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# descs: one op of each new type, appended by hand, byte-identical
# ---------------------------------------------------------------------------

F32, I64, I32 = "float32", "int64", "int32"
DESC_CASES = {
    "lrn": ({"X": [("x", [2, 5, 3, 3], F32)]},
            {"Out": ["o"], "MidOut": ["m"]}, {"n": 5}),
    "crop": ({"X": [("x", [4, 5], F32)]}, {"Out": ["o"]},
             {"shape": [2, 3], "offsets": [1, 1]}),
    "pad_constant_like": ({"X": [("x", [4, 5], F32)],
                           "Y": [("y", [2, 5], F32)]}, {"Out": ["o"]},
                          {"pad_value": 0.0}),
    "random_crop": ({"X": [("x", [3, 8, 8, 3], "uint8")]},
                    {"Out": ["o"], "SeedOut": ["s"]}, {"shape": [6, 6, 3]}),
    "shuffle_channel": ({"X": [("x", [2, 6, 3, 3], F32)]}, {"Out": ["o"]},
                        {"group": 2}),
    "space_to_depth": ({"X": [("x", [2, 3, 4, 4], F32)]}, {"Out": ["o"]},
                       {"blocksize": 2}),
    "max_pool2d_with_index": ({"X": [("x", [2, 3, 7, 7], F32)]},
                              {"Out": ["o"], "Mask": ["m"]},
                              {"ksize": [3, 3], "strides": [2, 2],
                               "paddings": [1, 1]}),
    "unpool": ({"X": [("x", [2, 3, 3, 3], F32)],
                "Indices": [("i", [2, 3, 3, 3], I32)]}, {"Out": ["o"]},
               {"unpooled_height": 6, "unpooled_width": 6}),
    "selu": ({"X": [("x", [3, 4], F32)]}, {"Out": ["o"]}, {}),
    "multiplex": ({"X": [("a", [4, 5], F32), ("b", [4, 5], F32)],
                   "Ids": [("i", [4, 1], I32)]}, {"Out": ["o"]}, {}),
    "sampling_id": ({"X": [("x", [4, 5], F32)]}, {"Out": ["o"]},
                    {"seed": 0}),
    "norm": ({"X": [("x", [3, 4, 5], F32)]}, {"Out": ["o"], "Norm": ["n"]},
             {"axis": 1, "epsilon": 1e-10}),
    "data_norm": ({"X": [("x", [4, 5], F32)],
                   "BatchSize": [("bs", [5], F32)],
                   "BatchSum": [("bsum", [5], F32)],
                   "BatchSquareSum": [("bsq", [5], F32)]},
                  {"Y": ["y"], "Means": ["m"], "Scales": ["s"]}, {}),
    "bilinear_tensor_product": ({"X": [("x", [4, 3], F32)],
                                 "Y": [("y", [4, 5], F32)],
                                 "Weight": [("w", [6, 3, 5], F32)]},
                                {"Out": ["o"]}, {}),
    "mean_iou": ({"Predictions": [("p", [20], I32)],
                  "Labels": [("l", [20], I32)]},
                 {"OutMeanIou": ["m"], "OutWrong": ["w"],
                  "OutCorrect": ["c"]}, {"num_classes": 6}),
    "conv_shift": ({"X": [("x", [3, 7], F32)], "Y": [("y", [3, 3], F32)]},
                   {"Out": ["o"]}, {}),
    "fill": ({}, {"Out": ["o"]}, {"shape": [2, 2], "value": [1, 2, 3, 4],
                                  "dtype": "float32"}),
    "reverse": ({"X": [("x", [3, 4], F32)]}, {"Out": ["o"]}, {"axis": [1]}),
    "gaussian_random_batch_size_like": (
        {"Input": [("x", [7, 3], F32)]}, {"Out": ["o"]},
        {"shape": [-1, 5], "mean": 0.0, "std": 1.0, "dtype": "float32"}),
    "grid_sampler": ({"X": [("x", [2, 3, 5, 6], F32)],
                      "Grid": [("g", [2, 4, 4, 2], F32)]},
                     {"Output": ["o"]}, {}),
    "affine_grid": ({"Theta": [("t", [2, 2, 3], F32)]}, {"Output": ["o"]},
                    {"output_shape": [2, 3, 4, 5]}),
    "spp": ({"X": [("x", [2, 3, 5, 7], F32)]}, {"Out": ["o"]},
            {"pyramid_height": 3, "pooling_type": "max"}),
    "similarity_focus": ({"X": [("x", [2, 3, 4, 5], F32)]}, {"Out": ["o"]},
                         {"axis": 1, "indexes": [0]}),
    "conv2d_transpose": ({"Input": [("x", [2, 4, 5, 5], F32)],
                          "Filter": [("w", [4, 3, 4, 4], F32)]},
                         {"Output": ["o"]},
                         {"strides": [2, 2], "paddings": [1, 1],
                          "dilations": [1, 1], "groups": 1}),
    "depthwise_conv2d_transpose": ({"Input": [("x", [2, 3, 4, 4], F32)],
                                    "Filter": [("w", [3, 1, 3, 3], F32)]},
                                   {"Output": ["o"]},
                                   {"strides": [2, 2], "paddings": [1, 1],
                                    "dilations": [1, 1], "groups": 3}),
    "huber_loss": ({"X": [("x", [6, 1], F32)], "Y": [("y", [6, 1], F32)]},
                   {"Out": ["o"], "Residual": ["r"]}, {"delta": 1.0}),
    "maxout": ({"X": [("x", [2, 6, 3, 4], F32)]}, {"Out": ["o"]},
               {"groups": 2}),
    "prelu": ({"X": [("x", [2, 3, 4, 4], F32)],
               "Alpha": [("a", [1, 3, 1, 1], F32)]}, {"Out": ["o"]},
              {"mode": "channel"}),
    "hash": ({"X": [("x", [6, 1], I64)]}, {"Out": ["o"]},
             {"num_hash": 2, "mod_by": 1000}),
    "uniform_random_batch_size_like": (
        {"Input": [("x", [7, 3], F32)]}, {"Out": ["o"]},
        {"shape": [-1, 5], "min": -1.0, "max": 1.0, "dtype": "float32"}),
    "group_norm": ({"X": [("x", [2, 6, 4, 5], F32)],
                    "Scale": [("s", [6], F32)], "Bias": [("b", [6], F32)]},
                   {"Y": ["y"], "Mean": ["m"], "Variance": ["v"]},
                   {"groups": 3, "epsilon": 1e-5}),
    "conv3d": ({"Input": [("x", [2, 3, 5, 6, 6], F32)],
                "Filter": [("w", [4, 3, 3, 3, 3], F32)]}, {"Output": ["o"]},
               {"strides": [1, 2, 2], "paddings": [1, 1, 1],
                "dilations": [1, 1, 1], "groups": 1}),
    "conv3d_transpose": ({"Input": [("x", [2, 4, 3, 4, 4], F32)],
                          "Filter": [("w", [4, 2, 3, 3, 3], F32)]},
                         {"Output": ["o"]},
                         {"strides": [2, 2, 2], "paddings": [1, 1, 1],
                          "dilations": [1, 1, 1], "groups": 1}),
    "pool3d": ({"X": [("x", [2, 3, 5, 7, 6], F32)]}, {"Out": ["o"]},
               {"pooling_type": "max", "ksize": [2, 3, 3],
                "strides": [2, 2, 2], "paddings": [1, 1, 0],
                "ceil_mode": True}),
    "max_pool3d_with_index": ({"X": [("x", [2, 3, 4, 6, 6], F32)]},
                              {"Out": ["o"], "Mask": ["m"]},
                              {"ksize": [2, 2, 2], "strides": [2, 2, 2],
                               "paddings": [0, 0, 0]}),
    "precision_recall": ({"Indices": [("i", [12, 1], I32)],
                          "Labels": [("l", [12, 1], I32)]},
                         {"BatchMetrics": ["b"], "AccumMetrics": ["a"],
                          "AccumStatesInfo": ["s"]}, {"class_number": 4}),
}


def test_desc_cases_cover_the_36_types():
    assert set(DESC_CASES) == set(NEW_IMAGE_NN)


@pytest.mark.parametrize("op_type", sorted(DESC_CASES))
def test_op_desc_bytes_match_jax(op_type):
    ins, outs, attrs = DESC_CASES[op_type]
    with junique.guard():
        j = _append(fluid, op_type, ins, outs, dict(attrs))
    with punique.guard():
        p = _append(pt, op_type, ins, outs, dict(attrs))
    assert p.desc.to_bytes() == j.desc.to_bytes()

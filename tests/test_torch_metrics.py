"""Host helpers of the port against the JAX package's, on the same
inputs: every metric of ``paddle_tpu_torch.metrics`` (updated over three
minibatches, then reset), ``WeightedAverage``, ``DataFeeder`` (``feed``,
``feed_parallel``, ``decorate_reader``) and ``lod_tensor``
(``LoDTensor``'s padded and nested encodings both ways,
``create_lod_tensor``, ``create_random_int_lodtensor`` under one numpy
seed, ``beam_decode_to_lod``). All host numpy in both packages, so every
result is equal, floats included."""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import average as javerage
from paddle_tpu import lod_tensor as jlod
from paddle_tpu import metrics as jmetrics

import paddle_tpu_torch as pt
from paddle_tpu_torch import average as paverage
from paddle_tpu_torch import lod_tensor as plod
from paddle_tpu_torch import metrics as pmetrics

RNG = np.random.RandomState(4)


def _binary(n=40):
    return RNG.rand(n).round(), (RNG.rand(n) > 0.5).astype(np.int64)


def _dets():
    det = np.zeros((2, 4, 6), np.float32)
    det[:, :, 0] = [[0, 1, 1, -1], [1, 0, 0, 1]]
    det[:, :, 1] = RNG.rand(2, 4)
    det[:, :, 2:4] = RNG.rand(2, 4, 2) * 5
    det[:, :, 4:6] = det[:, :, 2:4] + RNG.rand(2, 4, 2) * 5 + 1
    gt = np.zeros((2, 3, 5), np.float32)
    gt[:, :, 0] = [[0, 1, -1], [1, 1, 0]]
    gt[:, :, 1:3] = det[:, :3, 2:4] + RNG.rand(2, 3, 2)
    gt[:, :, 3:5] = det[:, :3, 4:6] + RNG.rand(2, 3, 2)
    return det, gt


def _updates(name):
    """Three minibatches of update() arguments for metric ``name``."""
    if name in ("Precision", "Recall"):
        return [_binary() for _ in range(3)]
    if name == "Accuracy":
        return [(RNG.rand(1).astype(np.float32), int(RNG.randint(1, 9)))
                for _ in range(3)]
    if name == "ChunkEvaluator":
        return [tuple(RNG.randint(0, 20, 1) for _ in range(3))
                for _ in range(3)]
    if name == "EditDistance":
        return [(RNG.randint(0, 4, (5, 1)).astype(np.float32), 5)
                for _ in range(3)]
    if name == "Auc":
        return [(RNG.rand(30, 2).astype(np.float32),
                 RNG.randint(0, 2, 30)) for _ in range(3)]
    if name in ("DetectionMAP", "DetectionMAP_11point"):
        return [_dets() for _ in range(3)]
    raise KeyError(name)


METRICS = ["Precision", "Recall", "Accuracy", "ChunkEvaluator",
           "EditDistance", "Auc", "DetectionMAP", "DetectionMAP_11point"]


def _make(mod, name):
    if name == "DetectionMAP_11point":
        return mod.DetectionMAP(ap_version="11point")
    if name == "Auc":
        return mod.Auc(num_thresholds=200)
    return getattr(mod, name)()


@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax(name):
    p, j = _make(pmetrics, name), _make(jmetrics, name)
    for args in _updates(name):
        p.update(*args)
        j.update(*args)
        assert np.array_equal(np.asarray(p.eval(), dtype=np.float64),
                              np.asarray(j.eval(), dtype=np.float64))
    p.reset()
    j.reset()
    if name in ("Precision", "Recall", "ChunkEvaluator"):
        assert p.eval() == j.eval()


def test_composite_metric_matches_jax():
    outs = []
    preds, labels = _binary()
    for mod in (pmetrics, jmetrics):
        c = mod.CompositeMetric()
        c.add_metric(mod.Precision())
        c.add_metric(mod.Recall())
        c.update(preds, labels)
        outs.append(c.eval())
    assert outs[0] == outs[1]
    assert set(pmetrics.__all__) == set(jmetrics.__all__)


def test_weighted_average_matches_jax():
    vals = [(RNG.rand(), int(RNG.randint(1, 5))) for _ in range(6)]
    vals.append((np.array([[0.25]], np.float32), 2))
    p, j = paverage.WeightedAverage(), javerage.WeightedAverage()
    for v, w in vals:
        p.add(v, w)
        j.add(v, w)
    assert p.eval() == j.eval()
    assert pt.WeightedAverage is paverage.WeightedAverage
    for avg in (p, j):
        avg.reset()
    for mod_avg in (p, j):
        with pytest.raises(ValueError):
            mod_avg.eval()
        with pytest.raises(ValueError, match="scalar"):
            mod_avg.add(np.ones(2), 1)


def _feeder(mod):
    main = mod.Program()
    with mod.program_guard(main, mod.Program()):
        img = mod.layers.data("img", shape=[2, 3], dtype="float32")
        lbl = mod.layers.data("lbl", shape=[1], dtype="int64")
    return mod.DataFeeder([img, "lbl"], mod.CPUPlace(), program=main)


def _rows(n=6):
    return [(RNG.rand(6).tolist(), [int(RNG.randint(0, 9))])
            for _ in range(n)]


def test_data_feeder_matches_jax():
    p, j = _feeder(pt), _feeder(fluid)
    rows = _rows()
    a, b = p.feed(rows), j.feed(rows)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])
    for pa, ja in zip(p.feed_parallel(rows, 3), j.feed_parallel(rows, 3)):
        for k in pa:
            np.testing.assert_array_equal(pa[k], ja[k])
    with pytest.raises(ValueError, match="split"):
        list(p.feed_parallel(rows, 4))
    rows7 = _rows(7)
    reader = pt.batch(lambda: iter(rows7), 3)
    got = list(p.decorate_reader(reader, multi_devices=True,
                                 num_places=3)())
    want = list(j.decorate_reader(reader, multi_devices=True,
                                  num_places=3)())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for gd, wd in zip(g, w):
            for k in gd:
                np.testing.assert_array_equal(gd[k], wd[k])


def test_lod_tensor_matches_jax():
    rows = [np.arange(3), np.arange(5) + 10, np.arange(2) + 20]
    for mod in (plod, jlod):
        assert mod.Tensor is mod.LoDTensor
    a = plod.create_lod_tensor([r.reshape(-1, 1) for r in rows], None)
    b = jlod.create_lod_tensor([r.reshape(-1, 1) for r in rows], None)
    assert a.recursive_sequence_lengths() == b.recursive_sequence_lengths()
    assert a.lod() == b.lod() and a.shape == b.shape
    for x, y in zip(a.to_padded(pad_value=-1), b.to_padded(pad_value=-1)):
        np.testing.assert_array_equal(x, y)
    nested = [[2, 1], [3, 5, 2]]
    pa = plod.LoDTensor(np.arange(10 * 2).reshape(10, 2), nested)
    ja = jlod.LoDTensor(np.arange(10 * 2).reshape(10, 2), nested)
    enc_p, enc_j = pa.to_nested_padded(), ja.to_nested_padded()
    for x, y in zip(enc_p, enc_j):
        np.testing.assert_array_equal(x, y)
    back = plod.LoDTensor.from_nested_padded(*enc_p)
    assert back.recursive_sequence_lengths() == nested
    np.testing.assert_array_equal(np.asarray(back), np.asarray(pa))
    with pytest.raises(ValueError, match="2 LoD levels"):
        a.to_nested_padded()
    np.random.seed(5)
    r1 = plod.create_random_int_lodtensor([[2, 3]], [4], None, 0, 9)
    np.random.seed(5)
    r2 = jlod.create_random_int_lodtensor([[2, 3]], [4], None, 0, 9)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
    assert r1.shape == [5, 4]


def test_beam_decode_to_lod_matches_jax():
    ids = np.array([[3, 4, 1, 7], [5, 1, 0, 0], [2, 2, 2, 2],
                    [9, 1, 1, 1]], np.int64)
    scores = np.array([0.5, 0.25, 0.125, 1.0], np.float32)
    p = plod.beam_decode_to_lod(ids, 2, 2, end_id=1, sentence_scores=scores)
    j = jlod.beam_decode_to_lod(ids, 2, 2, end_id=1, sentence_scores=scores)
    for a, b in zip(p, j):
        assert a.recursive_sequence_lengths() == b.recursive_sequence_lengths()
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="rows"):
        plod.beam_decode_to_lod(ids, 3, 2, end_id=1)

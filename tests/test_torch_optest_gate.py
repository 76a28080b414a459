"""The gradient-coverage gate of the port (tests/test_optest_gate.py is
the JAX package's, and its model).

Every gradful type of the port's registry (not a grad type, not
``no_grad``, with a grad maker) must be named in a vjp test held against
the JAX package: a ``test_*`` function of a ``tests/test_torch_*.py``
file whose name holds "vjp" or "grad" and whose body, decorators or the
module-level names they use hold the type's name as a string. Or it
stands in ``EXEMPT`` with the test that pins its gradient instead. An
exemption whose type gains such a test, or leaves the gradful types,
fails: the list only shrinks.

``VJP_CASES`` below are the vjp tests of the types no slice's own file
named: each type's generic vjp in both packages on the same seeded
cotangents, every float input's gradient within GRAD_REL of its largest
magnitude.
"""

import ast
import glob
import os
import re

import numpy as np
import pytest

import paddle_tpu_torch as pt

from test_torch_tensor_ops import (_no_callstack,  # noqa: F401
                                   assert_vjp_match)

GRAD_REL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))

# type -> where its gradient is held against the JAX package instead
EXEMPT = {
    "recurrent": "test_torch_recurrent.py::test_mt_path_grad_matches_jax "
                 "(the machine-translation decoder's recurrent op, its "
                 "step block's grads through the whole program)",
    "nce": "test_torch_loss_ops.py::test_nce_grad_matches_jax_on_the_ports"
           "_samples (the JAX op draws its own negatives: the port's "
           "samples are fed to both)",
}

_R = np.random.RandomState(2122)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _pos(*shape):
    return (_R.rand(*shape) + 0.5).astype(np.float32)


LEN = np.array([4, 1, 3], np.int64)
VJP_CASES = [
    ("affine_channel", {"X": [_f(2, 3, 4, 4)], "Scale": [_f(3)],
                        "Bias": [_f(3)]}, {"data_layout": "NCHW"}),
    ("assign", {"X": [_f(3, 4)]}, {}),
    ("batch_norm", {"X": [_f(4, 3, 5, 5)], "Scale": [_pos(3)],
                    "Bias": [_f(3)], "Mean": [_f(3)],
                    "Variance": [_pos(3)]},
     {"epsilon": 1e-5, "momentum": 0.9, "is_test": False}),
    ("clip_by_norm", {"X": [_f(4, 5)]}, {"max_norm": 1.5}),
    ("elementwise_max", {"X": [_f(3, 4)], "Y": [_f(3, 4)]}, {"axis": -1}),
    ("elementwise_pow", {"X": [_pos(3, 4)], "Y": [_f(4)]}, {"axis": -1}),
    ("elementwise_sub", {"X": [_f(3, 4, 2)], "Y": [_f(4)]}, {"axis": 1}),
    ("fc", {"Input": [_f(3, 2, 4)], "W": [_f(8, 5)], "Bias": [_f(5)]},
     {"in_num_col_dims": 1}),
    ("gather", {"X": [_f(6, 3)], "Index": [np.array([4, 0, 4, 2])]}, {}),
    ("log_softmax", {"X": [_f(3, 7)]}, {"axis": -1}),
    ("matmul", {"X": [_f(2, 3, 4)], "Y": [_f(2, 5, 4)]},
     {"transpose_X": False, "transpose_Y": True, "alpha": 0.5}),
    ("mean", {"X": [_f(3, 4)]}, {}),
    ("reduce_max", {"X": [_f(3, 4, 5)]}, {"dim": [1], "keep_dim": False}),
    ("reduce_mean", {"X": [_f(3, 4, 5)]}, {"dim": [0, 2], "keep_dim": True}),
    ("reduce_min", {"X": [_f(3, 4, 5)]}, {"dim": [-1], "keep_dim": False}),
    ("reduce_prod", {"X": [_pos(3, 4)]}, {"dim": [1], "keep_dim": False}),
    ("sequence_pool", {"X": [_f(3, 4, 5)], "Length": [LEN]},
     {"pooltype": "AVERAGE"}),
    ("sequence_softmax", {"X": [_f(3, 4)], "Length": [LEN]}, {}),
    ("softmax", {"X": [_f(3, 6)]}, {"axis": -1}),
    ("split", {"X": [_f(4, 6)]}, {"sections": [2, 4], "axis": 1}),
    ("transpose", {"X": [_f(2, 3, 4)]}, {"axis": [2, 0, 1]}),
    ("unsqueeze", {"X": [_f(3, 4)]}, {"axes": [0, 2]}),
    ("unsqueeze2", {"X": [_f(3, 4)]}, {"axes": [1]}),
    ("fused_elemwise_activation", {"X": [_f(3, 4)], "Y": [_f(3, 4)]},
     {"functor_list": ["elementwise_add", "relu"], "axis": -1}),
    ("fused_conv2d", {"Input": [_f(2, 3, 6, 6)], "Filter": [_f(4, 3, 3, 3)],
                      "Bias": [_f(4)]},
     {"conv_type": "conv2d", "strides": [1, 1], "paddings": [1, 1],
      "dilations": [1, 1], "groups": 1, "activation": "relu"}),
    ("gru", {"Input": [_f(3, 4, 6)], "Weight": [_f(2, 6)],
             "Bias": [_f(1, 6)], "Length": [LEN]},
     {"activation": "tanh", "gate_activation": "sigmoid",
      "is_reverse": False}),
]


@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_gate_op_vjp_matches_jax(case):
    op_type, ins, attrs = case
    assert_vjp_match(op_type, ins, attrs, rel=GRAD_REL)


def _strings(node):
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _names(node):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _vjp_named_types():
    """{type name string: file} of the strings the vjp tests name (an
    EXEMPT dict is not a test's)."""
    named = {}
    for path in sorted(glob.glob(os.path.join(HERE, "test_torch_*.py"))):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        assigns = {}
        for node in tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        assigns[t.id] = node.value
        for node in tree.body:
            if not (isinstance(node, ast.FunctionDef)
                    and node.name.startswith("test")
                    and re.search("vjp|grad", node.name)):
                continue
            found, seen, todo = _strings(node), set(), list(_names(node))
            while todo:
                n = todo.pop()
                if n in seen or n not in assigns or n == "EXEMPT":
                    continue
                seen.add(n)
                found |= _strings(assigns[n])
                todo.extend(_names(assigns[n]))
            for s in found:
                named.setdefault(s, os.path.basename(path))
    return named


def _gradful_types():
    return sorted(
        name for name, info in pt.registry._REGISTRY.items()
        if not (name.endswith("_grad") or "_grad_" in name)
        and not info.no_grad and info.grad_maker is not None)


def test_every_gradful_type_has_a_vjp_test_or_exemption():
    named = _vjp_named_types()
    missing = [t for t in _gradful_types()
               if t not in named and t not in EXEMPT]
    assert not missing, (
        f"{len(missing)} gradful type(s) named by no vjp test against the "
        f"JAX package: {missing}; add a case (VJP_CASES) or an EXEMPT "
        "entry naming the test that holds the gradient")


def test_exemptions_are_fresh():
    named = _vjp_named_types()
    stale = sorted(set(EXEMPT) & set(named))
    assert not stale, f"exempted types now have a vjp test: {stale}"
    unknown = sorted(set(EXEMPT) - set(_gradful_types()))
    assert not unknown, f"exempted names not gradful types: {unknown}"
    assert len(EXEMPT) < 10


def test_the_gate_sees_this_slices_types():
    named = _vjp_named_types()
    for t in ("fake_quantize_abs_max", "fake_quantize_range_abs_max",
              "fake_quantize_moving_average_abs_max",
              "fake_dequantize_max_abs", "rnn_memory_helper"):
        assert t in _gradful_types() and t in named, t
    assert named["fake_quantize_abs_max"] == "test_torch_quantize.py"

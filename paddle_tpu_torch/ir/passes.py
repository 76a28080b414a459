"""Pass registry and the pass set (counterpart of
``paddle_tpu/ir/passes.py``; reference ir/pass.h:32 Pass, PassRegistry,
REGISTER_PASS).

Ported: the framework, the passes a Transformer inference program
reaches (is_test, identity_scale_op_clean, fc_fuse, infer_clean_graph,
fuse_elewise_add_act, repeated_fc_relu_fuse), the conv passes
(conv_bn_fuse and conv_affine_channel_fuse, which fold values from the
Scope; the conv_elementwise_add fusions; fuse_relu_depthwise_conv;
conv_layout_nhwc), squared_mat_sub_fuse (the FM trick), the RNN and
sequence fusions (fc_gru_fuse, fc_lstm_fuse and embedding_fc_lstm_fuse,
which fold values from the Scope when they have it; seqpool_concat_fuse,
seqconv_eltadd_relu_fuse)
and the registry wrappers of the BuildStrategy op-list
stages (cse, constant_fold, dead_op_elimination, fuse_optimizer_ops,
fuse_attention, fuse_conv_epilogue). Each rewrites a program to the op
list the JAX package's pass gives.

graph_viz writes the block's graphviz dump (``Graph.to_dot``) to its
``graph_viz_path`` attr, as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Type

import numpy as np
import torch

from ..core.desc import OpDesc, VarDesc
from ..core.types import VarType
from .graph import Graph

PASS_REGISTRY: Dict[str, Type["Pass"]] = {}


def register_pass(cls: Type["Pass"]) -> Type["Pass"]:
    PASS_REGISTRY[cls.name] = cls
    return cls


def get_pass(name: str) -> "Pass":
    if name not in PASS_REGISTRY:
        raise KeyError(f"unknown pass {name!r}; have "
                       f"{sorted(PASS_REGISTRY)}")
    return PASS_REGISTRY[name]()


class Pass:
    """apply(graph) mutates the underlying BlockDesc in place."""

    name: str = ""

    def __init__(self):
        self.attrs = {}

    def set(self, key, value):
        self.attrs[key] = value
        return self

    def apply(self, graph: Graph):
        raise NotImplementedError


def apply_passes(program, names, scope=None, block_idx: int = 0,
                 protected=()):  # -> program (mutated in place)
    g = Graph(program, block_idx)
    for n in names:
        p = get_pass(n)
        p.set("scope", scope)
        p.set("protected", set(protected))
        p.apply(g)
        g.rebuild()
    # passes mutate desc.ops; resync the frontend Operator list so
    # anything walking block.ops afterwards sees the rewritten program
    from ..framework import Operator
    blk = program.block(block_idx)
    blk.ops[:] = [Operator(blk, d) for d in blk.desc.ops]
    # the executor memoizes rewritten op lists per program version
    program._bump()
    return program


@register_pass
class IsTestPass(Pass):
    """is_test_pass.cc analog: flip train-only ops into inference mode."""

    name = "is_test_pass"
    _ops = ("dropout", "batch_norm", "lrn", "group_norm")

    def apply(self, graph: Graph):
        for op in graph.ops:
            if op.type in self._ops and "is_test" in op.attrs:
                op.attrs["is_test"] = True


@register_pass
class IdentityScaleOpCleanPass(Pass):
    """identity_scale_op_clean_pass.cc analog: drop scale(1.0, 0.0)."""

    name = "identity_scale_op_clean_pass"

    def apply(self, graph: Graph):
        protected = self.attrs.get("protected", set())
        keep = []
        for i, op in enumerate(graph.ops):
            if (op.type == "scale"
                    and float(op.attrs.get("scale", 1.0)) == 1.0
                    and float(op.attrs.get("bias", 0.0)) == 0.0
                    and not graph.is_fetched(op.output("Out")[0],
                                             protected)):
                src = op.input("X")[0]
                dst = op.output("Out")[0]
                for later in graph.ops[i + 1:]:
                    later.rename_input(dst, src)
                continue
            keep.append(op)
        graph.replace_ops(keep)


@register_pass
class FCFusePass(Pass):
    """fc_fuse_pass.cc analog: mul + elementwise_add(persistable bias)
    -> one ``fc`` op (ops/kernels_nn.py). It sets ``in_num_col_dims``
    only, as the JAX pass does; no activation rides along."""

    name = "fc_fuse_pass"

    def apply(self, graph: Graph):
        protected = self.attrs.get("protected", set())
        ops = graph.ops
        fused = []
        consumed = set()
        for i, op in enumerate(ops):
            if i in consumed:
                continue
            if op.type != "mul":
                fused.append(op)
                continue
            out = op.output("Out")[0]
            j = graph.single_consumer(out)
            nxt = ops[j] if j is not None and j > i else None
            if (nxt is None or nxt.type != "elementwise_add"
                    or nxt.input("X") != [out]
                    or graph.is_fetched(out, protected)):
                fused.append(op)
                continue
            bias = nxt.input("Y")[0]
            bias_desc = graph.desc.vars.get(bias)
            if bias_desc is None or not bias_desc.persistable:
                fused.append(op)
                continue
            fused.append(OpDesc(
                "fc",
                {"Input": op.input("X"), "W": op.input("Y"),
                 "Bias": [bias]},
                {"Out": nxt.output("Out")},
                {"in_num_col_dims": op.attrs.get("x_num_col_dims", 1)}))
            consumed.add(j)
        graph.replace_ops(fused)


def _reads_same_at(graph: Graph, var: str, pos: int) -> bool:
    """True when reading `var` at op slot `pos` yields the value the
    matched subgraph read: every write of `var` (none for graph inputs)
    strictly precedes `pos`."""
    return all(w < pos for w in graph.writers.get(var, []))


def _splice(graph: Graph, fused_at: Dict[int, OpDesc], drop) -> None:
    """Replace ops at `fused_at` indices, drop the rest of `drop`."""
    if not fused_at:
        return
    out_ops = []
    for i, op in enumerate(graph.ops):
        if i in fused_at:
            out_ops.append(fused_at[i])
        elif i not in drop:
            out_ops.append(op)
    graph.replace_ops(out_ops)


@register_pass
class InferCleanGraphPass(Pass):
    """infer_clean_graph_pass.cc analog: strip feed/fetch plumbing ops
    and any var descs no surviving op references."""

    name = "infer_clean_graph_pass"
    _plumbing = ("feed", "fetch")

    def apply(self, graph: Graph):
        keep = [op for op in graph.ops if op.type not in self._plumbing]
        graph.replace_ops(keep)
        live = set()
        for op in keep:
            live.update(op.input_arg_names())
            live.update(op.output_arg_names())
        for name in list(graph.desc.vars):
            vd = graph.desc.vars[name]
            if name not in live and not vd.persistable:
                del graph.desc.vars[name]


@register_pass
class FuseElewiseAddActPass(Pass):
    """fuse_elewise_add_act_pass.cc analog. Two shapes:
    add(x, y) -> act(out)         => UnaryCompound [act, elementwise_add]
    act(y) -> add(x, act_out)     => BinaryCompound [elementwise_add, act]
    both lower to fused_elemwise_activation (ops/kernels_fused.py)."""

    name = "fuse_elewise_add_act_pass"
    _acts = ("relu", "sigmoid", "tanh", "scale")

    def apply(self, graph: Graph):
        from .pattern import (GraphPatternDetector, PNode,
                              intermediates_safe)
        protected = self.attrs.get("protected", set())
        for act in self._acts:
            # add -> act
            det = GraphPatternDetector(graph)
            pattern = [
                PNode("add", "elementwise_add",
                      inputs={"X": "x", "Y": "y"},
                      outputs={"Out": "add_out"}),
                PNode("act", act, inputs={"X": "add_out"},
                      outputs={"Out": "out"}),
            ]
            drop = set()
            fused_at = {}
            for m in det.detect(pattern):
                if not intermediates_safe(graph, m, ("x", "y", "out"),
                                          protected):
                    continue
                add = graph.ops[m.ops["add"]]
                act_op = graph.ops[m.ops["act"]]
                if act == "scale" and float(
                        act_op.attrs.get("bias", 0.0)) != 0.0:
                    continue  # the fused op has no scale-bias path
                attrs = {"functor_list": [act, "elementwise_add"],
                         "axis": int(add.attrs.get("axis", -1))}
                if act == "scale":
                    attrs["scale"] = float(act_op.attrs.get("scale", 1.0))
                fused_at[m.ops["add"]] = OpDesc(
                    "fused_elemwise_activation",
                    {"X": [m.vars["x"]], "Y": [m.vars["y"]]},
                    {"Out": [m.vars["out"]],
                     "IntermediateOut": [m.vars["add_out"]]},
                    attrs)
                drop.update(m.op_indices())
            _splice(graph, fused_at, drop)

            # act -> add (act feeds the add's Y side)
            det = GraphPatternDetector(graph)
            pattern = [
                PNode("act", act, inputs={"X": "y"},
                      outputs={"Out": "act_out"}),
                PNode("add", "elementwise_add",
                      inputs={"X": "x", "Y": "act_out"},
                      outputs={"Out": "out"}),
            ]
            drop = set()
            fused_at = {}
            for m in det.detect(pattern):
                if not intermediates_safe(graph, m, ("x", "y", "out"),
                                          protected):
                    continue
                # x must be live where the act sits (fused op moves up)
                if not _reads_same_at(graph, m.vars["x"], m.ops["act"]):
                    continue
                add = graph.ops[m.ops["add"]]
                act_op = graph.ops[m.ops["act"]]
                if act == "scale" and float(
                        act_op.attrs.get("bias", 0.0)) != 0.0:
                    continue
                attrs = {"functor_list": ["elementwise_add", act],
                         "axis": int(add.attrs.get("axis", -1))}
                if act == "scale":
                    attrs["scale"] = float(act_op.attrs.get("scale", 1.0))
                fused_at[m.ops["act"]] = OpDesc(
                    "fused_elemwise_activation",
                    {"X": [m.vars["x"]], "Y": [m.vars["y"]]},
                    {"Out": [m.vars["out"]],
                     "IntermediateOut": [m.vars["act_out"]]},
                    attrs)
                drop.update(m.op_indices())
            _splice(graph, fused_at, drop)


@register_pass
class RepeatedFCReluFusePass(Pass):
    """repeated_fc_relu_fuse_pass.cc analog: a chain of >=2 fc+relu
    pairs (run fc_fuse_pass first so mul+add are already fc) collapses
    into one fusion_repeated_fc_relu."""

    name = "repeated_fc_relu_fuse_pass"

    def apply(self, graph: Graph):
        protected = self.attrs.get("protected", set())
        ops = graph.ops
        drop = set()
        fused_at = {}
        i = 0
        while i < len(ops):
            chain = self._chain_from(graph, i, drop, protected)
            if chain is None or len(chain) < 2:
                i += 1
                continue
            idxs = [k for pair in chain for k in pair]
            first_fc = ops[chain[0][0]]
            last_relu = ops[chain[-1][1]]
            ws, bs = [], []
            for fc_i, _ in chain:
                ws.append(ops[fc_i].input("W")[0])
                bias = ops[fc_i].input("Bias")
                bs.append(bias[0] if bias else "")
            fused_at[chain[0][0]] = OpDesc(
                "fusion_repeated_fc_relu",
                {"X": first_fc.input("Input"), "W": ws, "Bias": bs},
                {"Out": list(last_relu.output("Out"))}, {})
            drop.update(idxs)
            i = chain[-1][1] + 1
        _splice(graph, fused_at, drop)

    @staticmethod
    def _plain_matmul_fc(graph: Graph, op) -> bool:
        """The fused op does a raw h @ w: only fuse fcs whose
        in_num_col_dims matches the input rank (no flatten step)."""
        vd = graph.desc.vars.get(op.input("Input")[0])
        if vd is None or not vd.shape:
            return False
        return int(op.attrs.get("in_num_col_dims", 1)) == len(vd.shape) - 1

    @staticmethod
    def _chain_from(graph: Graph, start, drop, protected):
        """Longest fc->relu->fc->relu... chain starting at op `start`."""
        ops = graph.ops
        chain = []
        i = start
        while True:
            if i is None or i in drop or ops[i].type != "fc":
                break
            if not RepeatedFCReluFusePass._plain_matmul_fc(graph, ops[i]):
                break
            fc_out = ops[i].output("Out")[0]
            j = graph.single_consumer(fc_out)
            if (j is None or ops[j].type != "relu"
                    or graph.is_fetched(fc_out, protected)):
                break
            relu_out = ops[j].output("Out")[0]
            chain.append((i, j))
            k = graph.single_consumer(relu_out)
            if k is None or graph.is_fetched(relu_out, protected):
                break
            i = k
        return chain or None


# ---------------------------------------------------------------------------
# conv passes
# ---------------------------------------------------------------------------

def _scope_array(scope, name) -> np.ndarray:
    """A scope value as a host numpy array."""
    v = scope.find_var(name)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _scope_store(scope, name, arr: np.ndarray, like=None):
    """Store a host array in the scope on the device of `like` (a scope
    value), the host when there is none."""
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    scope.set_var(name, torch.from_numpy(np.ascontiguousarray(arr)).to(
        device))


@register_pass
class ConvBNFusePass(Pass):
    """conv_bn_fuse_pass.cc / inference_transpiler.py analog: an
    inference-mode batch_norm (and the conv's bias add, if any) folds
    into the conv's weights by value, W' = W gamma / std per output
    channel and b' = (b - mean) gamma / std + beta, computed in numpy as
    the JAX package computes them, from the loaded values the Scope
    holds; the batch_norm becomes an axis-1 elementwise_add of b'. A conv
    whose filter is computed in the program (a frozen int8 weight's
    ``dequantize_weights``) has no value to fold into and keeps its
    batch_norm; the JAX pass raises there (ROADMAP §C)."""

    name = "conv_bn_fuse_pass"

    def apply(self, graph: Graph):
        scope = self.attrs.get("scope")
        if scope is None:
            raise ValueError("conv_bn_fuse_pass needs set('scope', scope)")
        protected = self.attrs.get("protected", set())
        ops = graph.ops
        out_ops = []
        consumed = set()
        for i, op in enumerate(ops):
            if i in consumed:
                continue
            if op.type not in ("conv2d", "depthwise_conv2d"):
                out_ops.append(op)
                continue
            chain = self._match(graph, i, protected)
            if chain is None:
                out_ops.append(op)
                continue
            add_idx, bn_idx = chain
            bn = ops[bn_idx]
            add = ops[add_idx] if add_idx is not None else None

            w_name = op.input("Filter")[0]
            w_like = scope.find_var(w_name)
            w = _scope_array(scope, w_name).copy()
            gamma = _scope_array(scope, bn.input("Scale")[0])
            beta = _scope_array(scope, bn.input("Bias")[0])
            mean = _scope_array(scope, bn.input("Mean")[0])
            var = _scope_array(scope, bn.input("Variance")[0])
            std = np.sqrt(var + float(bn.attrs.get("epsilon", 1e-5)))
            factor = gamma / std
            w *= factor.reshape([-1] + [1] * (w.ndim - 1))
            _scope_store(scope, w_name, w.astype(np.float32), w_like)

            if add is not None:
                b_name = add.input("Y")[0]
                b = _scope_array(scope, b_name).astype(np.float64)
            else:
                b_name = w_name + "@bn_fused_bias"
                b = np.zeros(w.shape[0], np.float64)
            _scope_store(scope, b_name,
                         ((b - mean) * factor + beta).astype(np.float32),
                         w_like)
            if b_name not in graph.desc.vars:
                graph.desc.vars[b_name] = VarDesc(
                    b_name, VarType.DENSE_TENSOR, None,
                    [int(w.shape[0])], persistable=True)

            out_ops.append(op)
            out_ops.append(OpDesc(
                "elementwise_add",
                {"X": op.output("Output"), "Y": [b_name]},
                {"Out": [bn.output("Y")[0]]}, {"axis": 1}))
            if add_idx is not None:
                consumed.add(add_idx)
            consumed.add(bn_idx)
        graph.replace_ops(out_ops)

    @staticmethod
    def _match(graph: Graph, conv_idx, protected):
        ops = graph.ops
        w_desc = graph.desc.vars.get(ops[conv_idx].input("Filter")[0])
        if w_desc is None or not w_desc.persistable:
            return None
        out = ops[conv_idx].output("Output")[0]
        j = graph.single_consumer(out)
        if j is None or j <= conv_idx or graph.is_fetched(out, protected):
            return None
        add_idx = None
        nxt = ops[j]
        if (nxt.type == "elementwise_add" and nxt.input("X") == [out]
                and int(nxt.attrs.get("axis", -1)) == 1):
            bias_desc = graph.desc.vars.get(nxt.input("Y")[0])
            if bias_desc is None or not bias_desc.persistable:
                return None
            add_idx = j
            out = nxt.output("Out")[0]
            j = graph.single_consumer(out)
            if j is None or graph.is_fetched(out, protected):
                return None
            nxt = ops[j]
        if nxt.type != "batch_norm" or nxt.input("X") != [out]:
            return None
        # folding the running statistics is only valid in inference mode
        # (run is_test_pass first on a program built for training)
        if not (nxt.attrs.get("is_test")
                or nxt.attrs.get("use_global_stats")):
            return None
        return add_idx, j


def _rank_of(block, name):
    try:
        shape = block.var(name).desc.shape
        return None if shape is None else len(shape)
    except Exception:  # noqa: BLE001 - metadata lookup, best effort
        return None


def _full_rank_residual(op, graph):
    """conv2d_fusion adds ResidualData with a plain broadcast, so the
    matched add must be a same-rank axis=-1 add (a second per-channel
    bias would change meaning)."""
    if int(op.attrs.get("axis", -1)) != -1:
        return False
    xd = graph.desc.vars.get(op.input("X")[0])
    yd = graph.desc.vars.get(op.input("Y")[0])
    return bool(xd is not None and yd is not None and xd.shape
                and yd.shape and len(xd.shape) == len(yd.shape))


def _per_channel_bias(op, graph):
    """An elementwise_add is a conv bias only when Y is a persistable 1-D
    per-channel vector added on axis 1 (the fused emitter reshapes Bias
    to (1, C, 1, 1))."""
    names = op.input("Y")
    if len(names) != 1 or int(op.attrs.get("axis", -1)) != 1:
        return False
    vd = graph.desc.vars.get(names[0])
    return bool(vd is not None and vd.persistable and vd.shape
                and len(vd.shape) == 1)


def _conv_bias_pattern(add_out="add_out"):
    from .pattern import PNode
    return [PNode("conv", "conv2d", inputs={"Input": "x", "Filter": "w"},
                  outputs={"Output": "conv_out"}),
            PNode("add", "elementwise_add",
                  inputs={"X": "conv_out", "Y": "bias"},
                  outputs={"Out": add_out}, predicate=_per_channel_bias)]


@register_pass
class ConvEltwiseAddActFusePass(Pass):
    """conv_elementwise_add_act_fuse_pass.cc analog: conv2d ->
    elementwise_add (persistable per-channel bias, axis=1) -> act
    collapses into one conv2d_fusion op."""

    name = "conv_elementwise_add_act_fuse_pass"
    _acts = ("relu", "sigmoid", "tanh")

    def apply(self, graph: Graph):
        from .pattern import GraphPatternDetector, PNode, intermediates_safe
        protected = self.attrs.get("protected", set())
        for act in self._acts:
            pattern = _conv_bias_pattern() + [
                PNode("act", act, inputs={"X": "add_out"},
                      outputs={"Out": "out"})]
            drop = set()
            fused_at = {}
            for m in GraphPatternDetector(graph).detect(pattern):
                if not intermediates_safe(graph, m,
                                          ("x", "w", "bias", "out"),
                                          protected):
                    continue
                conv = graph.ops[m.ops["conv"]]
                fused_at[m.ops["conv"]] = OpDesc(
                    "conv2d_fusion",
                    {"Input": [m.vars["x"]], "Filter": [m.vars["w"]],
                     "Bias": [m.vars["bias"]]},
                    {"Output": [m.vars["out"]]},
                    dict(conv.attrs, activation=act))
                drop.update(m.op_indices())
            _splice(graph, fused_at, drop)


@register_pass
class ConvEltwiseAddFusePass(Pass):
    """conv_elementwise_add_fuse_pass.cc analog: conv2d +
    elementwise_add (persistable per-channel bias) -> conv2d_fusion with
    the identity activation."""

    name = "conv_elementwise_add_fuse_pass"

    def apply(self, graph: Graph):
        from .pattern import GraphPatternDetector, intermediates_safe
        protected = self.attrs.get("protected", set())
        drop = set()
        fused_at = {}
        for m in GraphPatternDetector(graph).detect(
                _conv_bias_pattern("out")):
            if not intermediates_safe(graph, m, ("x", "w", "bias", "out"),
                                      protected):
                continue
            conv = graph.ops[m.ops["conv"]]
            fused_at[m.ops["conv"]] = OpDesc(
                "conv2d_fusion",
                {"Input": [m.vars["x"]], "Filter": [m.vars["w"]],
                 "Bias": [m.vars["bias"]]},
                {"Output": [m.vars["out"]]},
                dict(conv.attrs, activation="identity"))
            drop.update(m.op_indices())
        _splice(graph, fused_at, drop)


@register_pass
class ConvEltwiseAdd2ActFusePass(Pass):
    """conv_elementwise_add2_act_fuse_pass.cc analog: conv2d -> add
    (persistable bias) -> add (residual tensor) -> act collapses into
    conv2d_fusion with a ResidualData input (ResNet's shortcut join)."""

    name = "conv_elementwise_add2_act_fuse_pass"
    _acts = ("relu", "sigmoid", "tanh")

    def apply(self, graph: Graph):
        from .pattern import GraphPatternDetector, PNode, intermediates_safe
        protected = self.attrs.get("protected", set())
        for act in self._acts:
            pattern = _conv_bias_pattern("add1_out") + [
                PNode("add2", "elementwise_add",
                      inputs={"X": "add1_out", "Y": "residual"},
                      outputs={"Out": "add2_out"},
                      predicate=_full_rank_residual),
                PNode("act", act, inputs={"X": "add2_out"},
                      outputs={"Out": "out"})]
            drop = set()
            fused_at = {}
            for m in GraphPatternDetector(graph).detect(pattern):
                if not intermediates_safe(
                        graph, m, ("x", "w", "bias", "residual", "out"),
                        protected):
                    continue
                # the residual must already be live where the conv sits
                if not _reads_same_at(graph, m.vars["residual"],
                                      m.ops["conv"]):
                    continue
                conv = graph.ops[m.ops["conv"]]
                fused_at[m.ops["conv"]] = OpDesc(
                    "conv2d_fusion",
                    {"Input": [m.vars["x"]], "Filter": [m.vars["w"]],
                     "Bias": [m.vars["bias"]],
                     "ResidualData": [m.vars["residual"]]},
                    {"Output": [m.vars["out"]]},
                    dict(conv.attrs, activation=act))
                drop.update(m.op_indices())
            _splice(graph, fused_at, drop)


@register_pass
class ConvAffineChannelFusePass(Pass):
    """conv_affine_channel_fuse_pass.cc analog: an affine_channel (x *
    Scale[C] + Bias[C]) after a conv2d folds into the filter by value,
    W' = W scale_c, and its bias becomes the conv2d_fusion's Bias. Needs
    the Scope; refused when the filter has another consumer (it would
    see the scaled filter)."""

    name = "conv_affine_channel_fuse_pass"

    def apply(self, graph: Graph):
        scope = self.attrs.get("scope")
        if scope is None:
            raise ValueError(
                "conv_affine_channel_fuse_pass needs set('scope', scope)")
        from .pattern import GraphPatternDetector, PNode, intermediates_safe
        protected = self.attrs.get("protected", set())
        persistable = GraphPatternDetector.persistable
        pattern = [
            PNode("conv", "conv2d", inputs={"Input": "x", "Filter": "w"},
                  outputs={"Output": "conv_out"}),
            PNode("affine", "affine_channel",
                  inputs={"X": "conv_out", "Scale": "scale",
                          "Bias": "bias"},
                  outputs={"Out": "out"},
                  # the bias too: one computed between the conv and the
                  # affine would be read too early by the fused op at the
                  # conv's slot
                  predicate=lambda op, g: (persistable("Scale")(op, g)
                                           and persistable("Bias")(op, g))),
        ]
        drop = set()
        fused_at = {}
        for m in GraphPatternDetector(graph).detect(pattern):
            if not intermediates_safe(
                    graph, m, ("x", "w", "scale", "bias", "out"),
                    protected):
                continue
            w_name = m.vars["w"]
            if any(ci not in m.op_indices()
                   for ci in graph.consumers(w_name)):
                continue
            w_like = scope.find_var(w_name)
            w = _scope_array(scope, w_name).copy()
            scale = _scope_array(scope, m.vars["scale"])
            w *= scale.reshape([-1] + [1] * (w.ndim - 1))
            _scope_store(scope, w_name, w.astype(np.float32), w_like)
            conv = graph.ops[m.ops["conv"]]
            fused_at[m.ops["conv"]] = OpDesc(
                "conv2d_fusion",
                {"Input": [m.vars["x"]], "Filter": [w_name],
                 "Bias": [m.vars["bias"]]},
                {"Output": [m.vars["out"]]},
                dict(conv.attrs, activation="identity"))
            drop.update(m.op_indices())
        _splice(graph, fused_at, drop)


@register_pass
class FuseReluDepthwiseConvPass(Pass):
    """fuse_relu_depthwise_conv_pass.cc analog: a relu feeding a
    depthwise_conv2d folds into the conv's
    fuse_relu_before_depthwise_conv attr (the conv and its grad apply
    and differentiate the relu), so the pass is safe in training."""

    name = "fuse_relu_depthwise_conv_pass"

    def apply(self, graph: Graph):
        from .pattern import GraphPatternDetector, PNode, intermediates_safe
        protected = self.attrs.get("protected", set())
        pattern = [
            PNode("relu", "relu", inputs={"X": "x"},
                  outputs={"Out": "relu_out"}),
            PNode("conv", "depthwise_conv2d",
                  inputs={"Input": "relu_out", "Filter": "w"},
                  outputs={"Output": "out"}),
        ]
        drop = set()
        fused_at = {}
        for m in GraphPatternDetector(graph).detect(pattern):
            if not intermediates_safe(graph, m, ("x", "w", "out"),
                                      protected):
                continue
            # the fused conv reads x at the conv's slot: it must still
            # hold the value the relu read
            if not _reads_same_at(graph, m.vars["x"], m.ops["relu"]):
                continue
            conv = graph.ops[m.ops["conv"]]
            fused_at[m.ops["conv"]] = OpDesc(
                "depthwise_conv2d",
                {"Input": [m.vars["x"]], "Filter": [m.vars["w"]]},
                {"Output": [m.vars["out"]]},
                dict(conv.attrs, fuse_relu_before_depthwise_conv=True))
            drop.update(m.op_indices())
        _splice(graph, fused_at, drop)


@register_pass
class ConvLayoutNHWCPass(Pass):
    """The conv/pool/batch_norm spine of an NCHW program rewritten to
    NHWC before append_backward (grads then differentiate through the
    transposes it inserts): layout-aware ops take data_format /
    data_layout NHWC and pass NHWC tensors to each other (relu and the
    residual adds pass through), and a transpose materializes the NCHW
    value only where a layout-oblivious consumer (fc, a fetch) reads it.
    Filters stay OIHW."""

    name = "conv_layout_nhwc_pass"
    _LAYOUT_OPS = {"conv2d": ("Input", "Output", "data_format"),
                   "depthwise_conv2d": ("Input", "Output", "data_format"),
                   "pool2d": ("X", "Out", "data_format"),
                   "batch_norm": ("X", "Y", "data_layout")}
    # elementwise ops that run the same in either layout once every 4-D
    # operand is NHWC
    _PASSTHRU = ("relu", "relu6", "sigmoid", "tanh", "leaky_relu",
                 "elementwise_add", "elementwise_mul", "dropout", "scale",
                 "hard_swish", "swish")

    def apply(self, graph: Graph):
        protected = self.attrs.get("protected", set())
        block = graph.block
        nhwc_of: Dict[str, str] = {}   # NCHW var -> live NHWC twin
        back_done = set()              # NCHW vars already materialized
        rewritten = set()              # NCHW vars with no producer now
        new_ops: List[OpDesc] = []

        def mk_var(name, like):
            if block.has_var(name):
                return
            try:
                v = block.var(like)
                shape = list(v.desc.shape or [])
                if len(shape) == 4:
                    shape = [shape[p] for p in (0, 2, 3, 1)]
                block.create_var(name=name, dtype=v.dtype, shape=shape)
            except Exception:  # noqa: BLE001 - metadata only
                block.create_var(name=name)

        def to_nhwc(name):
            if name in nhwc_of:
                return nhwc_of[name]
            twin = name + "@NHWC"
            mk_var(twin, name)
            new_ops.append(OpDesc("transpose", {"X": [name]},
                                  {"Out": [twin]}, {"axis": [0, 2, 3, 1]}))
            nhwc_of[name] = twin
            return twin

        def back_to_nchw(name):
            if name in back_done:
                return
            new_ops.append(OpDesc("transpose", {"X": [nhwc_of[name]]},
                                  {"Out": [name]}, {"axis": [0, 3, 1, 2]}))
            back_done.add(name)

        def twin_of_out(name):
            twin = name + "@NHWC"
            mk_var(twin, name)
            nhwc_of[name] = twin
            rewritten.add(name)
            return twin

        def rank4(name):
            return _rank_of(block, name) == 4

        for op in graph.ops:
            info = self._LAYOUT_OPS.get(op.type)
            if info is not None \
                    and op.attrs.get(info[2], "NCHW") == "NCHW" \
                    and rank4(op.input(info[0])[0]):
                in_slot, out_slot, fmt = info
                out = op.output(out_slot)[0]
                inputs = {s: list(op.inputs[s]) for s in op.inputs}
                outputs = {s: list(op.outputs[s]) for s in op.outputs}
                inputs[in_slot] = [to_nhwc(op.input(in_slot)[0])]
                outputs[out_slot] = [twin_of_out(out)]
                new_ops.append(OpDesc(op.type, inputs, outputs,
                                      dict(op.attrs, **{fmt: "NHWC"})))
                if out in protected:
                    back_to_nchw(out)
                continue
            if op.type in self._PASSTHRU:
                tensor_ins = [n for s in op.inputs for n in op.inputs[s]]
                four_d = [n for n in tensor_ins if rank4(n)]
                attrs = dict(op.attrs)
                ok = four_d and all(n in nhwc_of for n in four_d)
                if ok and len(four_d) != len(tensor_ins):
                    # mixed ranks: only the per-channel broadcast (a
                    # rank-1 operand on the NCHW channel, axis=1) remaps,
                    # to axis=-1; axis=-1 in the NCHW program aligns with
                    # W and stays NCHW
                    low = [n for n in tensor_ins if not rank4(n)]
                    if (all(_rank_of(block, n) == 1 for n in low)
                            and attrs.get("axis", -1) == 1):
                        attrs["axis"] = -1
                    else:
                        ok = False
                if ok:
                    inputs = {s: [nhwc_of.get(n, n) for n in op.inputs[s]]
                              for s in op.inputs}
                    outputs = {s: [twin_of_out(n) if rank4(n) else n
                                   for n in op.outputs[s]]
                               for s in op.outputs}
                    new_ops.append(OpDesc(op.type, inputs, outputs, attrs))
                    for s in op.outputs:
                        for n in op.outputs[s]:
                            if rank4(n) and n in protected:
                                back_to_nchw(n)
                    continue
            # a layout-oblivious consumer: materialize NCHW for any input
            # whose producer now emits only the NHWC twin
            for n in set(op.input_arg_names()):
                if n in rewritten and n not in back_done:
                    back_to_nchw(n)
            new_ops.append(op)
        # anything rewritten and fetched or persistable still gets its
        # original name bound
        for n in sorted(rewritten):
            if n not in back_done and graph.is_fetched(n, protected):
                back_to_nchw(n)
        graph.replace_ops(new_ops)


# ---------------------------------------------------------------------------
# the BuildStrategy op-list stages as registry passes
# ---------------------------------------------------------------------------

class _OpListPass(Pass):
    """Bridge: run one of the op-list stages of ir/pipeline.py as a
    registry Pass over a Graph, so apply_passes and AnalysisConfig pass
    lists can use them too."""

    def _needed(self, graph: Graph):
        """Names the pass must keep bound: protected fetches plus every
        persistable var."""
        needed = set(self.attrs.get("protected", set()))
        for name, vd in graph.desc.vars.items():
            if vd.persistable:
                needed.add(name)
        return needed

    def _run(self, ops, needed, block):
        raise NotImplementedError

    def apply(self, graph: Graph):
        new_ops, _ = self._run(list(graph.ops), self._needed(graph),
                               graph.block)
        graph.replace_ops(new_ops)


@register_pass
class CSEPass(_OpListPass):
    """Common-subexpression elimination (memory_optimize component)."""

    name = "cse_pass"

    def _run(self, ops, needed, block):
        from .pipeline import cse_ops
        return cse_ops(ops, needed)


@register_pass
class ConstantFoldPass(_OpListPass):
    """Attr-rooted constant folding (memory_optimize component)."""

    name = "constant_fold_pass"

    def _run(self, ops, needed, block):
        from .pipeline import constant_fold_ops
        return constant_fold_ops(ops, needed)


@register_pass
class DeadOpEliminationPass(_OpListPass):
    """framework/prune.cc analog: drop ops reaching neither a protected
    fetch nor persistable state."""

    name = "dead_op_elimination_pass"

    def _run(self, ops, needed, block):
        from .pipeline import dead_op_elimination
        return dead_op_elimination(ops, needed)


@register_pass
class FuseOptimizerOpsPass(_OpListPass):
    """BuildStrategy.fuse_all_optimizer_ops as a registry pass: group
    per-parameter adam updates into multi-tensor fused ops (dtype is part
    of the grouping key)."""

    name = "fuse_optimizer_ops_pass"

    def _run(self, ops, needed, block):
        from .pipeline import block_var_dtype, fuse_optimizer_ops
        return fuse_optimizer_ops(ops, needed,
                                  var_dtype=block_var_dtype(block))


@register_pass
class FuseConvEpiloguePass(_OpListPass):
    """The conv stages as a registry pass: inference conv + bn chains and
    training conv + bias + act chains (forward and backward) become
    fused_conv2d. BuildStrategy route: ``fuse_conv_ops``."""

    name = "fuse_conv_epilogue_pass"

    def _run(self, ops, needed, block):
        from .pipeline import fuse_conv_bn_ops, fuse_conv_epilogue_ops
        ops, n_bn = fuse_conv_bn_ops(ops, needed, block)
        ops, n_epi = fuse_conv_epilogue_ops(ops, needed, block)
        return ops, n_bn + n_epi


@register_pass
class FuseAttentionPass(_OpListPass):
    """The unfused matmul/mask/softmax/matmul chain (and its backward)
    rewrites to the flash_attention op. BuildStrategy route:
    ``fuse_attention_ops``."""

    name = "fuse_attention_pass"

    def _run(self, ops, needed, block):
        from .pipeline import fuse_attention_chain_ops
        return fuse_attention_chain_ops(ops, needed, block)


# ---------------------------------------------------------------------------
# FM and detection fusions
# ---------------------------------------------------------------------------

@register_pass
class SquaredMatSubFusePass(Pass):
    """squared_mat_sub_fuse_pass.cc analog: the FM second-order
    interaction trick out = ((x@y)^2 - (x^2)@(y^2)) * scalar collapses
    into fusion_squared_mat_sub. Matches with and without the trailing
    scale op; a program that holds the op types but not the pattern is
    left as it is."""

    name = "squared_mat_sub_fuse_pass"

    def apply(self, graph: Graph):
        from .pattern import GraphPatternDetector, PNode, intermediates_safe
        protected = self.attrs.get("protected", set())

        def plain_mm(op, graph):
            return (not op.attrs.get("transpose_X")
                    and not op.attrs.get("transpose_Y")
                    and float(op.attrs.get("alpha", 1.0)) == 1.0)

        for with_scale in (True, False):
            det = GraphPatternDetector(graph)
            pattern = [
                PNode("mm_xy", "matmul", inputs={"X": "x", "Y": "y"},
                      outputs={"Out": "xy"}, predicate=plain_mm),
                PNode("sq_xy", "square", inputs={"X": "xy"},
                      outputs={"Out": "xy2"}),
                PNode("sq_x", "square", inputs={"X": "x"},
                      outputs={"Out": "x2"}),
                PNode("sq_y", "square", inputs={"X": "y"},
                      outputs={"Out": "y2"}),
                PNode("mm_x2y2", "matmul", inputs={"X": "x2", "Y": "y2"},
                      outputs={"Out": "x2y2"}, predicate=plain_mm),
                PNode("sub", "elementwise_sub",
                      inputs={"X": "xy2", "Y": "x2y2"},
                      outputs={"Out": "sub_out"}),
            ]
            if with_scale:
                pattern.append(PNode("scale", "scale",
                                     inputs={"X": "sub_out"},
                                     outputs={"Out": "out"}))
                keep = ("x", "y", "out")
            else:
                keep = ("x", "y", "sub_out")
            drop = set()
            fused_at = {}
            for m in det.detect(pattern):
                if not intermediates_safe(graph, m, keep, protected):
                    continue
                if with_scale:
                    sc_op = graph.ops[m.ops["scale"]]
                    if float(sc_op.attrs.get("bias", 0.0)) != 0.0:
                        continue
                    scalar = float(sc_op.attrs.get("scale", 1.0))
                    out = m.vars["out"]
                else:
                    scalar = 1.0
                    out = m.vars["sub_out"]
                # the fused op reads x and y at the last matched slot;
                # every write of them must precede the first
                first = min(m.op_indices())
                if not (_reads_same_at(graph, m.vars["x"], first)
                        and _reads_same_at(graph, m.vars["y"], first)):
                    continue
                fused_at[max(m.op_indices())] = OpDesc(
                    "fusion_squared_mat_sub",
                    {"X": [m.vars["x"]], "Y": [m.vars["y"]]},
                    {"Out": [out]}, {"scalar": scalar})
                drop.update(m.op_indices())
            _splice(graph, fused_at, drop)



# ---------------------------------------------------------------------------
# RNN and sequence fusions
# ---------------------------------------------------------------------------

class _FCRNNFuseBase(Pass):
    """fc_gru_fuse_pass.cc / fc_lstm_fuse_pass.cc analog: mul(X, WeightX)
    [-> elementwise_add(bias)] -> gru/lstm collapses into fusion_gru /
    fusion_lstm. With the Scope the projection bias is summed into the
    recurrence's Bias by value (in float32 numpy, as the JAX pass sums
    it; a peephole [7H] bias does not fold and its match is skipped);
    without it only the bias-free form fuses. The fused op takes the
    RNN's slot, so inputs made between the mul and the RNN are live."""

    rnn_type = ""
    fused_type = ""
    out_slots: Tuple[str, ...] = ()

    def apply(self, graph: Graph):
        from .pattern import GraphPatternDetector, PNode, intermediates_safe
        protected = self.attrs.get("protected", set())
        scope = self.attrs.get("scope")
        persistable = GraphPatternDetector.persistable
        for with_bias in (True, False):
            if with_bias and scope is None:
                continue
            pattern = [PNode("mul", "mul", inputs={"X": "x", "Y": "wx"},
                             outputs={"Out": "mul_out"},
                             predicate=persistable("Y"))]
            rnn_in = "mul_out"
            if with_bias:
                pattern.append(PNode(
                    "add", "elementwise_add",
                    inputs={"X": "mul_out", "Y": "fc_bias"},
                    outputs={"Out": "add_out"},
                    predicate=persistable("Y")))
                rnn_in = "add_out"
            pattern.append(PNode(
                "rnn", self.rnn_type,
                inputs={"Input": rnn_in, "Weight": "wh"},
                outputs={s: f"out_{s}" for s in self.out_slots}))
            keep = ["x", "wx", "wh", "fc_bias"] + [
                f"out_{s}" for s in self.out_slots]
            drop = set()
            fused_at = {}
            for m in GraphPatternDetector(graph).detect(pattern):
                if not intermediates_safe(graph, m, keep, protected):
                    continue
                rnn = graph.ops[m.ops["rnn"]]
                rnn_bias = rnn.input("Bias")
                bias_in = list(rnn_bias or [])
                if with_bias:
                    fcb = _scope_array(scope, m.vars["fc_bias"])
                    if rnn_bias and scope.find_var(rnn_bias[0]) is not None:
                        rb = _scope_array(scope, rnn_bias[0])
                        if rb.shape[-1] != fcb.size:
                            continue
                        _scope_store(scope, rnn_bias[0],
                                     (rb + fcb.reshape(rb.shape)).astype(
                                         rb.dtype),
                                     scope.find_var(rnn_bias[0]))
                    else:
                        bias_in = [m.vars["fc_bias"]]
                ins = {"X": [m.vars["x"]], "WeightX": [m.vars["wx"]],
                       "WeightH": [m.vars["wh"]], "Bias": bias_in}
                for slot in ("H0", "C0", "Length"):
                    if rnn.input(slot):
                        ins[slot] = list(rnn.input(slot))
                fused_at[m.ops["rnn"]] = OpDesc(
                    self.fused_type, ins,
                    {s: [m.vars[f"out_{s}"]] for s in self.out_slots},
                    dict(rnn.attrs))
                drop.update(m.op_indices())
            _splice(graph, fused_at, drop)


@register_pass
class FCGRUFusePass(_FCRNNFuseBase):
    name = "fc_gru_fuse_pass"
    rnn_type = "gru"
    fused_type = "fusion_gru"
    out_slots = ("Hidden",)


@register_pass
class FCLSTMFusePass(_FCRNNFuseBase):
    name = "fc_lstm_fuse_pass"
    rnn_type = "lstm"
    fused_type = "fusion_lstm"
    out_slots = ("Hidden", "Cell")


@register_pass
class EmbeddingFCLSTMFusePass(Pass):
    """embedding_fc_lstm_fuse_pass.cc analog: lookup_table -> mul(WeightX)
    [-> elementwise_add(fc bias)] -> lstm becomes fused_embedding_fc_lstm
    by folding the projection into the table by value, Embeddings = table
    @ WeightX (+ the fc bias on every row), computed in float64 numpy and
    stored in the table's dtype, as the JAX pass does. The folded table is
    a new persistable, named after the table and the projection (a table
    shared by two lstms through different weights folds twice). Needs
    the Scope."""

    name = "embedding_fc_lstm_fuse_pass"

    def apply(self, graph: Graph):
        scope = self.attrs.get("scope")
        if scope is None:
            raise ValueError(
                "embedding_fc_lstm_fuse_pass needs set('scope', scope)")
        from .pattern import GraphPatternDetector, PNode, intermediates_safe
        protected = self.attrs.get("protected", set())
        persistable = GraphPatternDetector.persistable
        for with_bias in (True, False):
            pattern = [
                PNode("emb", "lookup_table",
                      inputs={"W": "table", "Ids": "ids"},
                      outputs={"Out": "emb_out"}, predicate=persistable("W")),
                PNode("mul", "mul", inputs={"X": "emb_out", "Y": "wx"},
                      outputs={"Out": "mul_out"}, predicate=persistable("Y")),
            ]
            lstm_in = "mul_out"
            if with_bias:
                pattern.append(PNode(
                    "add", "elementwise_add",
                    inputs={"X": "mul_out", "Y": "fc_bias"},
                    outputs={"Out": "add_out"}, predicate=persistable("Y")))
                lstm_in = "add_out"
            pattern.append(PNode(
                "lstm", "lstm", inputs={"Input": lstm_in, "Weight": "wh"},
                outputs={"Hidden": "hidden", "Cell": "cell"}))
            drop = set()
            fused_at = {}
            for m in GraphPatternDetector(graph).detect(pattern):
                if not intermediates_safe(
                        graph, m, ("table", "ids", "wx", "wh", "fc_bias",
                                   "hidden", "cell"), protected):
                    continue
                # the fused op sits at the lstm's slot but must read the
                # Ids the lookup read: no write of them after the lookup
                if not _reads_same_at(graph, m.vars["ids"], m.ops["emb"]):
                    continue
                table_like = scope.find_var(m.vars["table"])
                table = _scope_array(scope, m.vars["table"])
                wx = _scope_array(scope, m.vars["wx"])
                folded = table.astype(np.float64) @ wx.astype(np.float64)
                if with_bias:
                    fcb = _scope_array(scope, m.vars["fc_bias"]).reshape(-1)
                    if fcb.shape[0] != folded.shape[-1]:
                        continue
                    folded = folded + fcb
                emb_name = (m.vars["table"] + "@" + m.vars["wx"]
                            + "@fc_folded")
                _scope_store(scope, emb_name, folded.astype(table.dtype),
                             table_like)
                if emb_name not in graph.desc.vars:
                    graph.desc.vars[emb_name] = VarDesc(
                        emb_name, VarType.DENSE_TENSOR, None,
                        [int(folded.shape[0]), int(folded.shape[1])],
                        persistable=True)
                lstm = graph.ops[m.ops["lstm"]]
                ins = {"Ids": [m.vars["ids"]], "Embeddings": [emb_name],
                       "WeightH": [m.vars["wh"]],
                       "Bias": list(lstm.input("Bias") or [])}
                for slot in ("H0", "C0", "Length"):
                    if lstm.input(slot):
                        ins[slot] = list(lstm.input(slot))
                fused_at[m.ops["lstm"]] = OpDesc(
                    "fused_embedding_fc_lstm", ins,
                    {"Hidden": [m.vars["hidden"]],
                     "Cell": [m.vars["cell"]]},
                    dict(lstm.attrs))
                drop.update(m.op_indices())
            _splice(graph, fused_at, drop)


@register_pass
class SeqPoolConcatFusePass(Pass):
    """fusion_seqpool_concat_op.cc route: a concat whose every input is a
    single-consumer sequence_pool, all of one pooltype, fuses into one
    fusion_seqpool_concat. The fused op takes the concat's slot, where
    every branch's input is live."""

    name = "seqpool_concat_fuse_pass"

    def apply(self, graph: Graph):
        protected = self.attrs.get("protected", set())
        ops = graph.ops
        drop = set()
        fused_at = {}
        for ci, cop in enumerate(ops):
            if cop.type != "concat" or len(cop.input("X")) < 2:
                continue
            pools = []
            for v in cop.input("X"):
                pi = graph.producer(v)
                if (pi is None or ops[pi].type != "sequence_pool"
                        or graph.single_consumer(v) != ci
                        or graph.is_fetched(v, protected) or pi in drop):
                    break
                pools.append(pi)
            else:
                ptypes = {ops[pi].attrs.get("pooltype", "SUM")
                          for pi in pools}
                if len(ptypes) != 1:
                    continue
                lens = [(ops[pi].input("Length") or [""])[0] for pi in pools]
                ins = {"X": [ops[pi].input("X")[0] for pi in pools]}
                if any(lens):
                    ins["Length"] = lens
                fused_at[ci] = OpDesc(
                    "fusion_seqpool_concat", ins,
                    {"Out": list(cop.output("Out"))},
                    {"pooltype": ptypes.pop(),
                     "axis": int(cop.attrs.get("axis", 1))})
                drop.update(pools)
        _splice(graph, fused_at, drop)

@register_pass
class TransposeFlattenConcatFusePass(Pass):
    """fusion_transpose_flatten_concat_op.cc route: N uniform transpose2 ->
    reshape2 (a [-1, k] flatten at axis 1) chains feeding one concat fuse
    into one op (the detection heads' pattern). The fused op takes the
    concat's slot."""

    name = "transpose_flatten_concat_fuse_pass"

    def apply(self, graph: Graph):
        protected = self.attrs.get("protected", set())
        ops = graph.ops
        drop = set()
        fused_at = {}
        for ci, cop in enumerate(ops):
            if cop.type != "concat" or len(cop.input("X")) < 2:
                continue
            chains = self._chains(graph, ci, cop, protected, drop)
            if chains is None:
                continue
            axes = {tuple(ops[ti].attrs.get("axis", ())) for ti, _ in chains}
            if len(axes) != 1 or not all(self._flattens_at_1(graph, ops[fi])
                                         for _, fi in chains):
                continue
            fused_at[ci] = OpDesc(
                "fusion_transpose_flatten_concat",
                {"X": [ops[ti].input("X")[0] for ti, _ in chains]},
                {"Out": list(cop.output("Out"))},
                {"trans_axis": list(axes.pop()), "flatten_axis": 1,
                 "concat_axis": int(cop.attrs.get("axis", 1))})
            for ti, fi in chains:
                drop.update((ti, fi))
        _splice(graph, fused_at, drop)

    @staticmethod
    def _chains(graph, ci, cop, protected, drop):
        """(transpose index, reshape index) per concat input, or None when
        an input is not a private transpose2 -> [-1, k] reshape2 chain."""
        ops = graph.ops
        chains = []
        for v in cop.input("X"):
            fi = graph.producer(v)
            fop = ops[fi] if fi is not None else None
            if (fop is None or fop.type != "reshape2"
                    or graph.single_consumer(v) != ci
                    or graph.is_fetched(v, protected) or fi in drop):
                return None
            rshape = list(fop.attrs.get("shape", ()))
            if len(rshape) != 2 or rshape[0] != -1:
                return None
            t_out = fop.input("X")[0]
            ti = graph.producer(t_out)
            top = ops[ti] if ti is not None else None
            if (top is None or top.type != "transpose2"
                    or graph.single_consumer(t_out) != fi
                    or graph.is_fetched(t_out, protected) or ti in drop):
                return None
            chains.append((ti, fi))
        return chains

    @staticmethod
    def _flattens_at_1(graph, fop):
        """The fused op splits the transposed shape at dim 1, so the
        reshape's k must be the product of the transposed dims after the
        first, all known."""
        td = graph.desc.vars.get(fop.input("X")[0])
        if td is None or not td.shape or any(
                s is None or s < 0 for s in td.shape[1:]):
            return False
        return int(np.prod([int(s) for s in td.shape[1:]])) == int(
            list(fop.attrs.get("shape", ()))[1])


@register_pass
class SeqConvEltAddReluFusePass(Pass):
    """seqconv_eltadd_relu_fuse_pass.cc analog: sequence_conv +
    elementwise_add of a persistable bias + relu -> one
    fusion_seqconv_eltadd_relu op, at the sequence_conv's place, with its
    Length when it has one."""

    name = "seqconv_eltadd_relu_fuse_pass"

    def apply(self, graph: Graph):
        from .pattern import GraphPatternDetector, PNode, intermediates_safe
        protected = self.attrs.get("protected", set())
        det = GraphPatternDetector(graph)
        pattern = [
            PNode("seqconv", "sequence_conv",
                  inputs={"X": "x", "Filter": "w"},
                  outputs={"Out": "conv_out"}),
            PNode("add", "elementwise_add",
                  inputs={"X": "conv_out", "Y": "bias"},
                  outputs={"Out": "add_out"},
                  predicate=GraphPatternDetector.persistable("Y")),
            PNode("relu", "relu", inputs={"X": "add_out"},
                  outputs={"Out": "out"}),
        ]
        drop = set()
        fused_at = {}
        for m in det.detect(pattern):
            if not intermediates_safe(graph, m, ("x", "w", "bias", "out"),
                                      protected):
                continue
            sc = graph.ops[m.ops["seqconv"]]
            ins = {"X": [m.vars["x"]], "Filter": [m.vars["w"]],
                   "Bias": [m.vars["bias"]]}
            if sc.input("Length"):
                ins["Length"] = list(sc.input("Length"))
            # only the window attrs the sequence_conv carries: both ops
            # derive the same defaults from the filter's shape
            fused_at[m.ops["seqconv"]] = OpDesc(
                "fusion_seqconv_eltadd_relu", ins, {"Out": [m.vars["out"]]},
                {k: sc.attrs[k] for k in ("contextLength", "contextStart")
                 if k in sc.attrs})
            drop.update(m.op_indices())
        _splice(graph, fused_at, drop)


@register_pass
class GraphVizPass(Pass):
    """graph_viz_pass.cc analog: write a .dot dump of the block."""

    name = "graph_viz_pass"

    def apply(self, graph: Graph):
        path = self.attrs.get("graph_viz_path", "program.dot")
        with open(path, "w") as f:
            f.write(graph.to_dot())

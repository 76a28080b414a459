"""Pass registry and the pass set (counterpart of
``paddle_tpu/ir/passes.py``; reference ir/pass.h:32 Pass, PassRegistry,
REGISTER_PASS).

Ported: the framework, the passes a Transformer inference program
reaches (is_test, identity_scale_op_clean, fc_fuse, infer_clean_graph,
fuse_elewise_add_act, repeated_fc_relu_fuse) and the registry wrappers
of the BuildStrategy op-list stages (cse, constant_fold,
dead_op_elimination, fuse_optimizer_ops, fuse_attention). Each rewrites
a program to the op list the JAX package's pass gives.

Not ported: the conv, RNN and sequence fusions and graph_viz. They are
registered under their names with a guard: a graph that holds every op
type the pass's pattern needs raises ``NotImplementedError`` naming the
ROADMAP item that ports the pass; any other graph is left unchanged,
since the pass cannot match without its anchor ops.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Type

from ..core.desc import OpDesc
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
class FuseAttentionPass(_OpListPass):
    """The unfused matmul/mask/softmax/matmul chain (and its backward)
    rewrites to the flash_attention op. BuildStrategy route:
    ``fuse_attention_ops``."""

    name = "fuse_attention_pass"

    def _run(self, ops, needed, block):
        from .pipeline import fuse_attention_chain_ops
        return fuse_attention_chain_ops(ops, needed, block)


# ---------------------------------------------------------------------------
# passes not ported yet: registered under their names behind a guard
# ---------------------------------------------------------------------------

_A5 = "ROADMAP A5 (conv fusions, with the ResNet-50 slice)"
_A10 = "ROADMAP A10 (observability)"
_A11 = "ROADMAP A11 (RNN, sequence and detection fusions)"


class _NotPortedPass(Pass):
    """A pass of the JAX package that the port does not have yet.

    ``needs`` is what its pattern needs, one tuple of alternative op types
    per pattern node it cannot match without. A graph that holds at least
    one op type of every tuple could match: the pass raises
    ``NotImplementedError`` naming ``roadmap``. Any other graph is left
    unchanged, which is what the JAX pass does with it."""

    needs: Tuple[Tuple[str, ...], ...] = ()
    roadmap = ""

    def apply(self, graph: Graph):
        present = {op.type for op in graph.ops}
        if all(present & set(alts) for alts in self.needs):
            raise NotImplementedError(
                f"{self.name} is not ported yet: it waits for "
                f"{self.roadmap}")


def _not_ported(name: str, needs: Sequence[Tuple[str, ...]], roadmap: str):
    register_pass(type(f"NotPorted_{name}", (_NotPortedPass,),
                       {"name": name, "needs": tuple(needs),
                        "roadmap": roadmap}))


_CONV = ("conv2d",)
_ANY_CONV = ("conv2d", "depthwise_conv2d")
_ACTS = ("relu", "sigmoid", "tanh")
for _name, _needs, _item in (
        ("conv_affine_channel_fuse_pass", (_CONV, ("affine_channel",)), _A5),
        ("conv_bn_fuse_pass", (_ANY_CONV, ("batch_norm",)), _A5),
        ("conv_elementwise_add_act_fuse_pass",
         (_CONV, ("elementwise_add",), _ACTS), _A5),
        ("conv_elementwise_add2_act_fuse_pass",
         (_CONV, ("elementwise_add",), _ACTS), _A5),
        ("conv_elementwise_add_fuse_pass", (_CONV, ("elementwise_add",)), _A5),
        ("fuse_relu_depthwise_conv_pass",
         (("relu",), ("depthwise_conv2d",)), _A5),
        ("fuse_conv_epilogue_pass", (_ANY_CONV,), _A5),
        ("conv_layout_nhwc_pass",
         (_ANY_CONV + ("pool2d", "batch_norm"),), _A5),
        ("embedding_fc_lstm_fuse_pass",
         (("lookup_table",), ("mul",), ("lstm",)), _A11),
        ("fc_gru_fuse_pass", (("mul",), ("gru",)), _A11),
        ("fc_lstm_fuse_pass", (("mul",), ("lstm",)), _A11),
        ("seqconv_eltadd_relu_fuse_pass",
         (("sequence_conv",), ("elementwise_add",), ("relu",)), _A11),
        ("squared_mat_sub_fuse_pass",
         (("matmul",), ("square",), ("elementwise_sub",)), _A11),
        ("seqpool_concat_fuse_pass", (("sequence_pool",), ("concat",)),
         _A11),
        ("transpose_flatten_concat_fuse_pass",
         (("transpose2",), ("reshape2",), ("concat",)), _A11),
        # writes a .dot file of any graph: nothing to match, always raises
        ("graph_viz_pass", (), _A10)):
    _not_ported(_name, _needs, _item)

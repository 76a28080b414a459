"""Program visualization helpers (debugger.py / graphviz.py /
net_drawer.py in the reference; counterpart of ``paddle_tpu/debugger.py``):
render a Block as graphviz. Built on the IR Graph's dot dump
(ir/graph.py to_dot), with optional highlighting of specific vars, the
debugging surface the reference exposes as
`fluid.debugger.draw_block_graphviz`.

`draw_program` is the verifier-aware successor: it renders
the def-use graph of every block with ir/verify.py diagnostics
annotated on the offending ops/vars — errors red, warnings orange,
each node's tooltip carrying the diagnostic text — so a failing
verify_program call has a one-call visual counterpart."""

from __future__ import annotations

__all__ = ["draw_program", "draw_block_graphviz",
           "pprint_program_codes"]


_SEV_FILL = {"error": "tomato", "warning": "orange", "info": "khaki"}
_SEV_RANK = {"error": 0, "warning": 1, "info": 2}


def _esc(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace('"', '\\"')


def draw_program(program, path=None, diagnostics=None,
                 feed_names=None, fetch_names=None) -> str:
    """Render `program`'s def-use graph as graphviz dot with verifier
    diagnostics annotated: an op with a finding fills red (error) /
    orange (warning) / khaki (info) and carries the diagnostic text in
    its label and tooltip; offending vars outline red. Runs
    `ir.verify.verify_program` when `diagnostics` is not supplied.
    Returns the dot text; also writes it to `path` when given."""
    from .ir import verify as _verify

    if diagnostics is None:
        diagnostics = _verify.verify_program(
            program, feed_names=feed_names,
            fetch_names=fetch_names).diagnostics
    by_op = {}
    by_var = {}
    for d in diagnostics:
        key = (d.block_idx, d.op_idx)
        if d.op_idx is not None:
            cur = by_op.get(key)
            if cur is None or _SEV_RANK[d.severity] < _SEV_RANK[
                    cur.severity]:
                by_op[key] = d
        if d.var:
            cur = by_var.get(d.var)
            if cur is None or _SEV_RANK[d.severity] < _SEV_RANK[
                    cur.severity]:
                by_var[d.var] = d

    desc = getattr(program, "desc", program)
    lines = ["digraph program {", "  rankdir=TB;",
             '  node [shape=box, fontsize=10];']
    seen_vars = set()

    def var_node(bi, n):
        vid = f"var_b{bi}_{n}"
        for ch in ".@/":
            vid = vid.replace(ch, "_")
        if (bi, n) not in seen_vars:
            d = by_var.get(n)
            extra = ""
            if d is not None:
                extra = (f', color={_SEV_FILL[d.severity]}, '
                         f'penwidth=2, tooltip="{_esc(d.message)}"')
            lines.append(f'  {vid} [label="{_esc(n)}", shape=ellipse, '
                         f'fontsize=9{extra}];')
            seen_vars.add((bi, n))
        return vid

    for blk in desc.blocks:
        bi = blk.idx
        for i, op in enumerate(blk.ops):
            oid = f"op_b{bi}_{i}"
            d = by_op.get((bi, i))
            label = op.type
            style = 'style=filled, fillcolor=lightsteelblue'
            tooltip = ""
            if d is not None:
                label = f"{op.type}\\n[{d.severity}] {d.code}"
                style = (f'style=filled, '
                         f'fillcolor={_SEV_FILL[d.severity]}')
                tooltip = f', tooltip="{_esc(d.format())}"'
            lines.append(f'  {oid} [label="{_esc(label)}", '
                         f'{style}{tooltip}];')
            for n in op.input_arg_names():
                if n:
                    lines.append(f"  {var_node(bi, n)} -> {oid};")
            for n in op.output_arg_names():
                if n:
                    lines.append(f"  {oid} -> {var_node(bi, n)};")
    lines.append("}")
    text = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def draw_block_graphviz(block, highlights=None, path="./temp.dot"):
    """Write `block`'s op/var graph as a .dot file; vars whose name
    contains any `highlights` entry render filled red."""
    from .ir.graph import Graph

    g = Graph(block.program, block.idx if hasattr(block, "idx") else 0)
    text = g.to_dot()
    if highlights:
        lines = []
        for line in text.splitlines():
            if any(h in line for h in highlights) and "ellipse" in line:
                line = line.replace(
                    "shape=ellipse,",
                    "shape=ellipse, style=filled, fillcolor=red,")
            lines.append(line)
        text = "\n".join(lines)
    with open(path, "w") as f:
        f.write(text)
    return path


def pprint_program_codes(program):
    """debugger.pprint_program_codes: a readable text dump of every
    block's ops (type, inputs -> outputs)."""
    out = []
    for idx in range(program.num_blocks):
        block = program.block(idx)
        out.append(f"-- block {idx} --")
        for op in block.desc.ops:
            ins = {k: v for k, v in op.inputs.items() if v}
            outs = {k: v for k, v in op.outputs.items() if v}
            out.append(f"  {op.type}: {ins} -> {outs}")
    text = "\n".join(out)
    print(text)
    return text

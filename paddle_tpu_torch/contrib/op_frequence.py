"""Op-frequency statistics (contrib/op_frequence.py parity; counterpart
of ``paddle_tpu/contrib/op_frequence.py``): which op
types dominate a program, alone and as adjacent producer->consumer
pairs — the quick signal for which fusion pass to write next."""

from __future__ import annotations

from collections import OrderedDict

from ..framework import Program

__all__ = ["op_freq_statistic"]


def op_freq_statistic(program):
    """Count op types and adjacent (producer,consumer) op-type pairs in
    block 0, parameters excluded; both dicts come back sorted by count,
    descending, pair keys joined as "producer,consumer"
    (contrib/op_frequence.py:23 `op_freq_statistic`)."""
    if not isinstance(program, Program):
        raise TypeError("op_freq_statistic expects a Program, got "
                        f"{type(program).__name__}")
    params = {p.name for p in program.global_block().all_parameters()}
    block = program.global_block().desc

    uni = {}
    producer = {}
    adj = {}
    for op in block.ops:
        outs = [n for n in op.output_arg_names() if n not in params]
        if outs:
            uni[op.type] = uni.get(op.type, 0) + 1
        for name in op.input_arg_names():
            if not name or name in params:
                continue
            src = producer.get(name)
            if src is not None:
                key = f"{src},{op.type}"
                adj[key] = adj.get(key, 0) + 1
        for name in outs:
            producer[name] = op.type

    by_count = lambda d: OrderedDict(
        sorted(d.items(), key=lambda kv: kv[1], reverse=True))
    return by_count(uni), by_count(adj)

"""The compression controller (reference contrib/slim/core/
compress_pass.py: Context:8, CompressPass:31): it owns the training loop
and calls each strategy's callbacks around it."""

from __future__ import annotations

import numpy as np

from ..graph import get_executor

__all__ = ["Context", "CompressPass"]


class Context:
    """The state the strategies' callbacks share."""

    def __init__(self, exe, graph, scope, program_exe=None):
        self.epoch = 0
        self.epoch_id = 0
        self.batch_id = 0
        self.exe = exe
        self.graph = graph
        self.scope = scope
        self.program_exe = program_exe


class CompressPass:
    """Run the compression training loop. ``data_reader`` yields feed
    dicts (or rows a ``data_feeder`` turns into them); the ``metrics``
    ({name: Variable}) are fetched every batch and handed to
    ``on_metrics`` (by default printed). ``place`` None runs the loop on
    the card."""

    def __init__(self, place=None, data_reader=None, data_feeder=None,
                 scope=None, metrics=None, epoch=None, program_exe=None,
                 on_metrics=None):
        self.strategies = []
        self.place = place
        self.data_reader = data_reader
        self.data_feeder = data_feeder
        self.scope = scope
        self.metrics = metrics
        self.epoch = epoch or 0
        self.program_exe = program_exe
        self.on_metrics = on_metrics

    def add_strategy(self, strategy):
        self.strategies.append(strategy)
        self.epoch = max(strategy.end_epoch, self.epoch)

    def apply(self, graph):
        """Train ``epoch`` epochs over ``data_reader`` with every
        strategy's callbacks firing; returns the Context."""
        executor = get_executor(graph, self.place)
        context = Context(executor, graph, self.scope,
                          program_exe=self.program_exe)
        context.epoch = self.epoch

        for s in self.strategies:
            s.on_compress_begin(context)
        for _ in range(self.epoch):
            for s in self.strategies:
                s.on_epoch_begin(context)
            context.batch_id = 0
            for data in self.data_reader():
                for s in self.strategies:
                    s.on_batch_begin(context)
                fetches = (list(self.metrics.values())
                           if self.metrics else None)
                feed = (self.data_feeder.feed(data)
                        if self.data_feeder else data)
                results = executor.run(graph, fetches=fetches, feed=feed,
                                       scope=self.scope)
                if results is not None and self.metrics:
                    named = dict(zip(self.metrics.keys(), results))
                    if self.on_metrics:
                        self.on_metrics(context, named)
                    else:
                        print(f"epoch {context.epoch_id} batch "
                              f"{context.batch_id}: " + ", ".join(
                                  f"{k}={float(np.asarray(v).ravel()[0]):.6g}"
                                  for k, v in named.items()))
                for s in self.strategies:
                    s.on_batch_end(context)
                context.batch_id += 1
            for s in self.strategies:
                s.on_epoch_end(context)
            context.epoch_id += 1
        for s in self.strategies:
            s.on_compress_end(context)
        return context

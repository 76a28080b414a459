"""DataFeeder (counterpart of ``paddle_tpu/data_feeder.py``; reference
python/paddle/fluid/data_feeder.py): reader rows (tuples of arrays or
lists) into the executor's feed dict, batched and cast to the declared
data variables' dtypes."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .core.types import dtype_to_numpy
from .framework import Variable


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None):
        self.feed_vars: List[Variable] = []
        for v in feed_list:
            if isinstance(v, str):
                from .framework import default_main_program
                v = (program or default_main_program()).global_block().var(v)
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable):
        """rows: iterable of tuples aligned with feed_list -> feed dict of
        stacked batch arrays."""
        columns = [[] for _ in self.feed_vars]
        for row in iterable:
            for c, item in zip(columns, row):
                c.append(np.asarray(item))
        out = {}
        for var, col in zip(self.feed_vars, columns):
            dt = dtype_to_numpy(var.dtype)
            batch = np.stack(col).astype(dt)
            shape = var.shape
            if shape is not None:
                want = [len(col)] + [s for s in shape[1:]]
                if all(s is not None and s > 0 for s in want):
                    batch = batch.reshape(want)
            out[var.name] = batch
        return out

    def feed_parallel(self, iterable, num_places=None):
        """Split one batch row-wise into ``num_places`` feed dicts (the
        reference's ParallelExecutor feeding)."""
        whole = self.feed(iterable)
        n = num_places or 1
        if not whole:
            raise ValueError("feed_parallel: empty feed_list")
        first = next(iter(whole.values()))
        b = first.shape[0]
        if b % n != 0:
            raise ValueError(
                f"batch of {b} rows does not split over {n} places; "
                "drop the remainder (paddle.batch drop_last=True)")
        per = b // n
        for i in range(n):
            yield {k: v[i * per:(i + 1) * per]
                   for k, v in whole.items()}

    def decorate_reader(self, reader, multi_devices=False,
                        num_places=None, drop_last=True):
        """Wrap a batch reader so each batch it yields is a feed dict (or
        per-place dicts)."""
        def wrapped():
            n = num_places or 1
            for batch in reader():
                batch = list(batch)
                if multi_devices and drop_last and len(batch) % n != 0:
                    continue  # indivisible tail: dropped, not fatal
                if multi_devices:
                    yield list(self.feed_parallel(batch, num_places))
                else:
                    yield self.feed(batch)
        return wrapped

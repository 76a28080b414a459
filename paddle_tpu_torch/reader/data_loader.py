"""DataLoader: batches from a Python reader, copied to the device ahead
of the step that takes them (counterpart of
``paddle_tpu/reader/data_loader.py``; reference layers/io.py py_reader and
operators/reader/buffered_reader.cc's device prefetch).

A thread pulls batches from the reader, casts each feed to its declared
dtype and starts its copy to the device ``capacity`` batches ahead. On the
card a batch is copied into a pinned host buffer (a ring per feed, each
buffer rewritten only after its last copy has left) and sent on a copy
stream of the loader's own (``staging.PinnedStaging``). The batch the caller takes is a dict of
device tensors: taking it makes the caller's current stream wait for the
batch's copy, and records the tensors' use on that stream, so the
allocator keeps them until the step that reads them is done. The
executor takes device tensors as feeds (a captured plan copies them into
its static buffers on the device), so nothing goes back to the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.types import dtype_to_numpy
from ..framework import Variable
from ..place import CUDAPlace, Place
from ..staging import PinnedStaging


def _device(device) -> torch.device:
    """The loader's device: the card unless the caller names another."""
    if device is None:
        return CUDAPlace(0).torch_device
    if isinstance(device, Place):
        return device.torch_device
    return torch.device(device)


class DataLoader:
    """``steps_per_batch=K > 1`` assembles super-batches for the
    executor's K-step runs (``Executor.run(iterations=K)``): K consecutive
    batches stacked on a new leading axis, [K, batch, ...], copied as one.
    A last group of fewer than K batches is yielded stacked to its length;
    pass that length as ``iterations`` for the tail call.

    The cursor ``(epoch, offset)``: ``offset`` counts the per-step batches
    the caller has taken this epoch (a super-batch advances it by its
    length). ``state_dict()`` returns it (checkpoints keep it as
    train_state.json's ``data_cursor``) and ``load_state_dict()`` restores
    it: the next ``__iter__`` pulls and drops the first ``offset`` batches
    of the reader on the loader's thread, so a resumed run sees exactly
    the batches the interrupted one did not train on. One ``__iter__`` is
    one epoch; an epoch run to its end advances ``epoch`` and zeroes
    ``offset``. The fast-forward replays the reader, so it must give the
    same batches each time for an epoch (seed it by epoch).

    ``device`` is a Place, a ``torch.device`` or None (the card);
    ``sharding`` (placement over a mesh) waits for ROADMAP A12."""

    def __init__(self, feed_list: Sequence[Variable], capacity: int = 2,
                 device=None, sharding=None, steps_per_batch: int = 1):
        if sharding is not None:
            raise NotImplementedError(
                "DataLoader(sharding=...) waits for ROADMAP A12 "
                "(multi-device)")
        self.feed_vars = list(feed_list)
        self.capacity = capacity
        self.device = _device(device)
        self.steps_per_batch = max(1, int(steps_per_batch))
        self._reader: Optional[Callable] = None
        self._stager = None
        self._epoch = 0       # completed epochs
        self._offset = 0      # per-step batches taken this epoch
        self._skip = 0        # per-step batches to drop at the next iter

    def state_dict(self) -> Dict[str, int]:
        """The cursor {"epoch", "offset"} as of the batches taken (call it
        between steps, so offset counts the steps trained this epoch)."""
        return {"epoch": int(self._epoch), "offset": int(self._offset)}

    def load_state_dict(self, state: Dict[str, int]):
        """Restore a cursor from ``state_dict``: the next ``__iter__``
        drops ``offset`` batches of the reader before yielding."""
        self._epoch = int(state.get("epoch", 0))
        self._offset = self._skip = int(state.get("offset", 0))
        return self

    def set_batch_generator(self, reader, places=None):
        """reader() yields dicts {name: ndarray} or tuples aligned with
        feed_list."""
        self._reader = reader
        return self

    def set_sample_list_generator(self, reader, places=None):
        """reader() yields lists of per-sample tuples; the loader stacks
        them into batch arrays."""

        def batched():
            for sample_list in reader():
                cols = list(zip(*sample_list))
                yield tuple(np.stack([np.asarray(s) for s in col])
                            for col in cols)

        self._reader = batched
        return self

    def _to_feed_dict(self, item) -> Dict[str, np.ndarray]:
        if isinstance(item, dict):
            out = dict(item)
        else:
            out = {v.name: arr for v, arr in zip(self.feed_vars, item)}
        for v in self.feed_vars:
            arr = np.asarray(out[v.name])
            want = dtype_to_numpy(v.dtype)
            if arr.dtype != want:
                arr = arr.astype(want)
            out[v.name] = arr
        return out

    def _to_device(self, feed):
        """(device tensors, the event their copies record or None)."""
        if self._stager is None:
            return {k: torch.from_numpy(np.array(a)).to(self.device)
                    for k, a in feed.items()}, None
        tensors, done = self._stager.stage(
            (k, a, None, None) for k, a in feed.items())
        return dict(zip(feed, tensors)), done

    def __iter__(self):
        if self._reader is None:
            raise RuntimeError("set_batch_generator first")
        if self.device.type == "cuda" and self._stager is None:
            # a buffer per queued batch, the caller's and the one filling
            self._stager = PinnedStaging(self.device, self.capacity + 2)
        q: queue.Queue = queue.Queue(maxsize=self.capacity)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            # gives up when the caller has left the loop, so an early
            # break does not pin ``capacity`` batches forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stack_steps(feeds):
            return {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}

        # the resume fast-forward is this iteration's alone
        skip, self._skip = int(self._skip), 0

        def produce():
            try:
                pending = []
                to_skip = skip
                for item in self._reader():
                    if to_skip > 0:
                        to_skip -= 1
                        continue
                    feed = self._to_feed_dict(item)
                    if self.steps_per_batch <= 1:
                        if not put((1, self._to_device(feed))):
                            return
                        continue
                    pending.append(feed)
                    if len(pending) == self.steps_per_batch:
                        if not put((len(pending),
                                    self._to_device(stack_steps(pending)))):
                            return
                        pending = []
                if pending:
                    if not put((len(pending),
                                self._to_device(stack_steps(pending)))):
                        return
            except BaseException as e:  # raised on the caller's thread
                put(("error", e))
            else:
                put(end)

        t = threading.Thread(target=produce, daemon=True,
                             name="data-loader")
        t.start()
        completed = False
        try:
            while True:
                item = q.get()
                if item is end:
                    completed = True
                    break
                if item[0] == "error":
                    raise item[1]
                nsteps, (feed, done) = item
                if done is not None:
                    self._stager.hand_off(feed.values(), done)
                # the cursor counts batches the caller took, not the ones
                # prefetched
                self._offset += nsteps
                yield feed
        finally:
            stop.set()
            if completed:
                self._epoch += 1
                self._offset = 0

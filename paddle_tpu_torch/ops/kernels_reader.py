"""Program-level reader ops (counterpart of
``paddle_tpu/ops/kernels_reader.py``; reference operators/reader/:
create_py_reader_op.cc, read_op.cc, buffered_reader.cc,
lod_tensor_blocking_queue.h).

The program contract is the reference's: ``create_py_reader`` in the
startup program makes the reader's queue, a ``read`` op in the main
program pops the next batch, exhaustion raises ``EOFException``, and the
handle's ``start()``/``reset()`` drive the thread that fills the queue.
Both are host ops: the executor runs ``read`` between device segments,
and the segments after it still capture and replay, their inputs copied
into the plan's static buffers. With ``use_double_buffer`` the filling
thread sends each batch to the executor's device on a copy stream of the
reader's own, from pinned buffers, so the copy overlaps the previous
step; ``read`` makes the current stream wait for it.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..core import EOFException
from ..registry import register_op
from ..staging import PinnedStaging


_EOF = object()


class _ProducerError:
    """An exception of the filling thread, raised again by ``next()``."""

    def __init__(self, exc):
        self.exc = exc


class PyReaderState:
    """The blocking queue and filling thread behind one reader variable
    (LoDTensorBlockingQueue)."""

    def __init__(self, name: str, capacity: int, dtypes, shapes,
                 use_double_buffer: bool = True, device=None):
        self.name = name
        self.capacity = capacity
        self.dtypes = list(dtypes)
        self.shapes = [list(s) for s in shapes]
        self.use_double_buffer = use_double_buffer
        self.device = device if device is not None else torch.device("cpu")
        self._source = None
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stager = None

    def decorate(self, source):
        """source() yields tuples of ndarrays (or tensors) aligned with
        shapes."""
        self._source = source

    def _to_device(self, arrs):
        """The batch as tensors on the device: through pinned buffers on
        the copy stream with double buffering on the card (with the
        event the copies record), else a plain copy."""
        if any(isinstance(a, torch.Tensor) for a in arrs):
            # a Preprocessor's outputs, made on the device already
            return tuple(a.to(self.device) if isinstance(a, torch.Tensor)
                         else torch.from_numpy(np.array(a)).to(self.device)
                         for a in arrs), None
        if self.use_double_buffer and self.device.type == "cuda":
            if self._stager is None:
                self._stager = PinnedStaging(self.device, self.capacity + 2)
            batch, done = self._stager.stage(
                (i, a, None, None) for i, a in enumerate(arrs))
            return tuple(batch), done
        return tuple(torch.from_numpy(np.array(a)).to(self.device)
                     for a in arrs), None

    def start(self):
        if self._source is None:
            raise RuntimeError(
                f"py_reader {self.name!r}: no data source decorated")
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                f"py_reader {self.name!r} already started; call reset() "
                "after EOF before starting again")
        self._stop.clear()
        self._queue = queue.Queue(maxsize=self.capacity)

        def worker():
            try:
                for item in self._source():
                    if self._stop.is_set():
                        return
                    arrs = [a if isinstance(a, torch.Tensor)
                            else np.asarray(a) for a in (
                        item if isinstance(item, (tuple, list)) else (item,))]
                    self._queue.put(self._to_device(arrs))
            except BaseException as e:  # noqa: BLE001
                # a source's error reaches the reader as an error, not EOF
                self._queue.put(_ProducerError(e))
                return
            self._queue.put(_EOF)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name=f"py-reader-{self.name}")
        self._thread.start()

    def next(self):
        if self._queue is None:
            raise RuntimeError(
                f"py_reader {self.name!r}: start() not called")
        item = self._queue.get()
        if item is _EOF:
            raise EOFException(f"py_reader {self.name!r} exhausted")
        if isinstance(item, _ProducerError):
            raise RuntimeError(
                f"py_reader {self.name!r}: data source raised"
            ) from item.exc
        batch, done = item
        if done is not None:
            self._stager.hand_off(batch, done)
        return batch

    def reset(self):
        """Drain and rewind, after EOF or in the middle of an epoch."""
        self._stop.set()
        if self._queue is not None:
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._thread = None
        self._queue = None


_READERS: Dict[str, PyReaderState] = {}


def get_reader(name: str) -> PyReaderState:
    return _READERS[name]


@register_op("create_py_reader", no_grad=True, is_host=True)
def create_py_reader_op(ctx, ins, attrs):
    """Startup-program op: (re)make the queue of a reader variable on the
    run's device, and put the reader in the scope under its variable's
    name (where the ``read`` op finds it). Running the startup program
    again resets the queue and keeps the decorated source."""
    name = attrs["reader_name"]
    prev = _READERS.get(name)
    if prev is not None:
        prev.reset()
    state = PyReaderState(
        name, int(attrs.get("capacity", 2)),
        attrs.get("dtypes", []), attrs.get("shapes", []),
        bool(attrs.get("use_double_buffer", True)), ctx.device)
    if prev is not None and prev._source is not None:
        state._source = prev._source
    _READERS[name] = state
    ctx.scope.set_var(name, state)
    return {}


@register_op("read", no_grad=True, is_host=True)
def read_op(ctx, ins, attrs):
    """Pop the next batch; raises EOFException at the end of the
    source."""
    state = _READERS[attrs["reader_name"]]
    return {"Out": list(state.next())}

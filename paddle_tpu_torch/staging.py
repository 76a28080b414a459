"""Host feeds on their way to the card: pinned staging buffers and a
copy stream, shared by the serving front (``inference/serving.py``),
the ``DataLoader`` (``reader/data_loader.py``) and ``py_reader``
(``ops/kernels_reader.py``).

A feed is written into a pinned host buffer and copied to the card with
``non_blocking=True`` on a copy stream of its own, so the copy overlaps
the step on the compute stream. Each (key, shape, dtype) has a ring of
``depth`` buffers used in turns; a buffer is rewritten only after its
last copy has left, which its event records. ``stage`` returns the
device tensors and that event; ``hand_off`` makes the stream that reads
them wait for it and records their use there, so the allocator keeps
them until that stream is done. The serving front hands off at once, the
readers when the caller takes the batch.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PinnedStaging:
    def __init__(self, device: torch.device, depth: int = 2):
        self.device = device
        self.depth = max(1, int(depth))
        self.stream = torch.cuda.Stream(device)
        self.rings: Dict[tuple, list] = {}
        # several threads stage through one object: a front's callers, or
        # a loop the caller left and the next loop's thread
        self.lock = threading.Lock()

    def stage(self, items: Iterable[Tuple[object, np.ndarray,
                                          Optional[Sequence[int]],
                                          Optional[torch.dtype]]]
              ) -> Tuple[List[torch.Tensor], torch.cuda.Event]:
        """Each ``(key, value, shape, dtype)``: ``value`` cast to
        ``dtype`` and zero-padded to ``shape`` (None: its own) in the
        next buffer of its ring, sent on the copy stream. Returns the
        device tensors, in order, and the event recorded after their
        copies."""
        done = torch.cuda.Event()
        out = []
        with self.lock:
            for key, value, shape, dtype in items:
                src = torch.from_numpy(np.ascontiguousarray(value))
                shape = tuple(src.shape if shape is None else shape)
                dtype = src.dtype if dtype is None else dtype
                ring = self.rings.get((key, shape, dtype))
                if ring is None:
                    ring = self.rings[key, shape, dtype] = [
                        [torch.empty(shape, dtype=dtype, pin_memory=True),
                         None] for _ in range(self.depth)] + [0]
                slot = ring[ring[-1]]
                ring[-1] = (ring[-1] + 1) % self.depth
                buf, last = slot
                if last is not None:
                    last.synchronize()  # its previous copy has left
                buf[tuple(slice(0, n) for n in src.shape)].copy_(src)
                # the pad: every element outside the value's extent
                for d, n in enumerate(src.shape):
                    if n < shape[d]:
                        buf[tuple([slice(0, m) for m in src.shape[:d]]
                                  + [slice(n, None)])].zero_()
                with torch.cuda.stream(self.stream):
                    out.append(buf.to(self.device, non_blocking=True))
                slot[1] = done
            done.record(self.stream)
        return out, done

    def hand_off(self, tensors: Iterable[torch.Tensor],
                 done: torch.cuda.Event):
        """The current stream waits for ``done`` before it reads
        ``tensors`` (made on the copy stream), which the allocator keeps
        until that stream's work on them is done."""
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        for t in tensors:
            t.record_stream(compute)

"""Input layers (counterpart of ``paddle_tpu/layers/io.py``; reference
python/paddle/fluid/layers/io.py: data, py_reader, read_file,
double_buffer).

``py_reader`` puts ``create_py_reader`` in the startup program and
returns a ``PyReader`` handle; ``read_file`` emits the ``read`` op whose
outputs feed the program, so a training loop runs ``exe.run(main)`` with
no feed dict and catches ``core.EOFException`` at the end of an epoch.
``open_files`` (RecordIO files) waits for ROADMAP A13;
``random_data_generator``, ``Preprocessor`` and ``load`` are not
ported.
"""

from __future__ import annotations

import numpy as np

from ..core.types import VarType, dtype_to_str
from ..framework import default_main_program, default_startup_program
from ..layer_helper import LayerHelper

__all__ = ["data", "py_reader", "read_file", "double_buffer",
           "create_py_reader_by_data", "shuffle", "PyReader"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare an input variable; ``append_batch_size`` prepends -1 like
    the reference. Ragged inputs use the padded + length convention, so
    ``lod_level`` is accepted for API parity only."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.block.create_var(
        name=name, shape=shape, dtype=dtype, stop_gradient=stop_gradient)


class PyReader:
    """The handle of a program-level reader: decorate a source, then
    ``start()`` and ``reset()`` its filling thread; the ``read`` op feeds
    the program. A source may be decorated before the startup program
    makes the queue: it is kept here and bound at ``start()`` (or at once
    when the queue exists). Transforms (``layers.shuffle``) compose over
    the source in the order they were added, whichever came first."""

    def __init__(self, reader_var, capacity, shapes, dtypes,
                 use_double_buffer):
        self.reader_var = reader_var
        self.name = reader_var.name
        self.capacity = capacity
        self.shapes = [list(s) for s in shapes]
        self.dtypes = list(dtypes)
        self.use_double_buffer = use_double_buffer
        self._raw_source = None
        self._source = None
        self._transforms = []

    def _state(self):
        from ..ops.kernels_reader import get_reader
        return get_reader(self.name)

    def _bind_source(self, source):
        self._raw_source = source
        src = source
        for t in self._transforms:
            src = t(src)
        self._source = src
        from ..ops.kernels_reader import _READERS
        state = _READERS.get(self.name)
        if state is not None:
            state.decorate(self._source)
        return self

    def _add_transform(self, transform):
        self._transforms.append(transform)
        if self._raw_source is not None:
            self._bind_source(self._raw_source)
        return self

    def decorate_paddle_reader(self, reader, places=None):
        """reader() yields lists of per-sample tuples (a reader wrapped by
        ``batch``); the handle stacks each into batch arrays."""
        def batched():
            for sample_list in reader():
                cols = list(zip(*sample_list))
                yield tuple(np.stack([np.asarray(s) for s in col])
                            for col in cols)
        return self._bind_source(batched)

    decorate_sample_list_generator = decorate_paddle_reader

    def decorate_batch_generator(self, reader, places=None):
        """reader() yields whole-batch tuples of ndarrays."""
        return self._bind_source(reader)

    decorate_tensor_provider = decorate_batch_generator

    def start(self):
        state = self._state()
        if state._source is None and self._source is not None:
            state.decorate(self._source)
        state.start()

    def reset(self):
        self._state().reset()


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """A program-level reader: ``create_py_reader`` in the startup
    program (running it makes the queue; running it again resets it) and
    a ``PyReader`` handle; ``read_file`` gives the main program's
    outputs. Batches need uniform shapes (``batch(..., drop_last=True)``):
    a captured plan is made per feed shape."""
    helper = LayerHelper("py_reader", name=name)
    reader_name = name or helper.name
    main_block = default_main_program().global_block()
    reader_var = main_block.create_var(
        name=reader_name, shape=[0], dtype="float32", stop_gradient=True)
    reader_var.desc.type = VarType.READER
    startup_block = default_startup_program().global_block()
    startup_block.create_var(name=reader_name, shape=[0], dtype="float32")
    create_op = startup_block.append_op(
        type="create_py_reader", inputs={}, outputs={"Out": [reader_name]},
        attrs={"reader_name": reader_name, "capacity": int(capacity),
               "shapes": [list(s) for s in shapes],
               "dtypes": [str(d) for d in dtypes],
               "use_double_buffer": bool(use_double_buffer)})
    out = PyReader(reader_var, capacity, shapes, dtypes, use_double_buffer)
    out._create_op = create_op
    return out


def read_file(reader):
    """The ``read`` op: one output variable per reader slot."""
    helper = LayerHelper("read_file")
    outs = []
    for shape, dtype in zip(reader.shapes, reader.dtypes):
        outs.append(helper.block.create_var(
            name=f"{reader.name}_out{len(outs)}", shape=list(shape),
            dtype=dtype, stop_gradient=True))
    helper.append_op(type="read", inputs={"Reader": reader.reader_var},
                     outputs={"Out": outs},
                     attrs={"reader_name": reader.name})
    return outs if len(outs) > 1 else outs[0]


def double_buffer(reader, place=None, name=None):
    """Copy the reader's batches to the device ahead of use (py_reader's
    default); the flag goes into the startup program's op too, so a
    later startup run keeps it."""
    reader.use_double_buffer = True
    create_op = getattr(reader, "_create_op", None)
    if create_op is not None:
        create_op.set_attr("use_double_buffer", True)
    from ..ops.kernels_reader import _READERS
    state = _READERS.get(reader.name)
    if state is not None:
        state.use_double_buffer = True
    return reader


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """A py_reader whose slots take the shapes and dtypes of
    ``feed_list``'s variables."""
    shapes = [list(v.shape) for v in feed_list]
    dtypes = [dtype_to_str(v.dtype) for v in feed_list]
    return py_reader(capacity, shapes, dtypes, name=name,
                     use_double_buffer=use_double_buffer)


def shuffle(reader, buffer_size):
    """Shuffle the reader's batch stream through a buffer of
    ``buffer_size`` batches (a transform of its source)."""
    from ..reader import decorator

    if not isinstance(reader, PyReader):
        raise TypeError("layers.shuffle expects a py_reader handle")
    return reader._add_transform(
        lambda source: decorator.shuffle(source, buffer_size))

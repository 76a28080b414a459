"""Graph-building frontend: Program / Block / Operator / Variable.

Counterpart of ``paddle_tpu/framework.py`` (reference
python/paddle/fluid/framework.py): a Program is the user-visible handle
over a ProgramDesc; every layer call appends Operators; shape/dtype
inference runs eagerly at append_op time through the registry's infer
rules. Programs are pure data; executor.py runs them.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, List, Optional

from . import registry
from .utils import unique_name
from .core.desc import BlockDesc, OpDesc, ProgramDesc, VarDesc
from .core.types import (OP_ROLE_ATTR_NAME, DataType, OpRole, VarType,
                         convert_dtype)


class Variable:
    """Symbolic handle to a VarDesc within a Block."""

    def __init__(self, block: "Block", name: str,
                 type: VarType = VarType.DENSE_TENSOR,
                 dtype=DataType.FP32, shape=None,
                 persistable: bool = False, stop_gradient: bool = False):
        self.block = block
        if block.has_var_recursive(name):
            self.desc = block._find_var_desc_recursive(name)
        else:
            self.desc = VarDesc(name, type,
                                convert_dtype(dtype) if dtype is not None else None,
                                shape, persistable, stop_gradient)
            block.desc.vars[name] = self.desc
        block.vars[name] = self

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape) if self.desc.shape is not None else None

    @property
    def dtype(self) -> DataType:
        return self.desc.dtype

    @property
    def type(self) -> VarType:
        return self.desc.type

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @persistable.setter
    def persistable(self, v):
        self.desc.persistable = v

    @property
    def stop_gradient(self) -> bool:
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v):
        self.desc.stop_gradient = v

    def __repr__(self):
        return (f"Variable({self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    # arithmetic appends elementwise ops (the JAX package's math_op_patch)
    def _binary(self, other, op, reverse=False):
        from .layers import math_op_patch
        return math_op_patch.binary_op(self, other, op, reverse)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    def __radd__(self, o):
        return self._binary(o, "elementwise_add", True)

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    def __rmul__(self, o):
        return self._binary(o, "elementwise_mul", True)

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", True)


class Parameter(Variable):
    """Trainable, persistable variable."""

    def __init__(self, block, name, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.do_model_average = kwargs.pop("do_model_average", False)
        super().__init__(block, name, VarType.DENSE_TENSOR, dtype, shape,
                         persistable=True, stop_gradient=False)

    def _copy_attrs_from(self, src: "Parameter"):
        self.trainable = src.trainable
        self.regularizer = src.regularizer
        self.gradient_clip_attr = src.gradient_clip_attr
        self.optimize_attr = src.optimize_attr
        self.do_model_average = src.do_model_average


_PKG_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep
# model-zoo frames are the creation site a diagnostic should name
_MODELS_DIR = os.path.join(_PKG_DIR, "models") + os.sep


def _capture_callstack(limit: int = 4) -> Optional[List[str]]:
    """The op's creation site: up to ``limit`` user frames (outside this
    package's plumbing; the model zoo counts as user code), innermost
    first. Gated on FLAGS_op_callstack."""
    from .utils.flags import FLAGS
    if not FLAGS.op_callstack:
        return None
    out: List[str] = []
    f = sys._getframe(2)
    while f is not None and len(out) < limit:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR) or fn.startswith(_MODELS_DIR):
            out.append(f"{fn}:{f.f_lineno} in {f.f_code.co_name}")
        f = f.f_back
    return out or None


class Operator:
    """Wrapper over an OpDesc."""

    def __init__(self, block: "Block", desc: OpDesc):
        self.block = block
        self.desc = desc

    @property
    def type(self) -> str:
        return self.desc.type

    def input(self, slot):
        return self.desc.input(slot)

    def output(self, slot):
        return self.desc.output(slot)

    @property
    def input_arg_names(self):
        return self.desc.input_arg_names()

    @property
    def output_arg_names(self):
        return self.desc.output_arg_names()

    @property
    def attrs(self):
        return self.desc.attrs

    def attr(self, name):
        return self.desc.attrs.get(name)

    def set_attr(self, name, val):
        self.desc.attrs[name] = val

    def __repr__(self):
        return f"Operator({self.desc!r})"


class Block:
    def __init__(self, program: "Program", idx: int):
        self.program = program
        self.desc: BlockDesc = program.desc.blocks[idx]
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def idx(self) -> int:
        return self.desc.idx

    @property
    def parent_idx(self) -> int:
        return self.desc.parent_idx

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.desc.parent_idx < 0:
            return None
        return self.program.block(self.desc.parent_idx)

    def create_var(self, name=None, **kwargs) -> Variable:
        if name is None:
            name = unique_name.generate("_generated_var")
        if name in self.vars:
            return self.vars[name]
        return Variable(self, name, **kwargs)

    def create_parameter(self, name, shape, dtype, **kwargs) -> Parameter:
        return Parameter(self, name, shape, dtype, **kwargs)

    def var(self, name: str) -> Variable:
        v = self._var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def _var_recursive(self, name: str) -> Optional[Variable]:
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def has_var_recursive(self, name: str) -> bool:
        return self._var_recursive(name) is not None

    def _find_var_desc_recursive(self, name: str) -> Optional[VarDesc]:
        v = self._var_recursive(name)
        return v.desc if v is not None else None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        """Append an op. A variable created inside a ``layers.Switch``
        case is written only under its case's name, so it has no value
        after the switch: reading it raises here (in this block or a
        sub-block), and writing it clears the mark."""
        names = _to_name_map(inputs)
        for slot_names in names.values():
            for n in slot_names:
                v = self._var_recursive(n) if n else None
                if v is not None and getattr(v, "_switch_case_local", False):
                    raise ValueError(
                        f"variable '{n}' was created inside a "
                        "layers.Switch case and is undefined after the "
                        "switch; create it before the switch (so the case "
                        "write is merged) or read it inside the case")
        for slot_names in _to_name_map(outputs).values():
            for n in slot_names:
                v = self._var_recursive(n) if n else None
                if v is not None and getattr(v, "_switch_case_local", False):
                    v._switch_case_local = False
        # at the desc's end, as the JAX package's: a rewrite of
        # ``desc.ops`` alone (the quantize transpiler's) can leave it longer
        # than ``self.ops``
        return self._insert_op(len(self.ops), type, inputs, outputs, attrs,
                               desc_index=len(self.desc.ops))

    def _insert_op(self, index: int, type: str, inputs=None, outputs=None,
                   attrs=None, desc_index=None) -> Operator:
        desc = OpDesc(type, _to_name_map(inputs), _to_name_map(outputs),
                      dict(attrs or {}))
        desc.callstack = _capture_callstack()
        if OP_ROLE_ATTR_NAME not in desc.attrs:
            desc.attrs[OP_ROLE_ATTR_NAME] = int(self.program._current_role)
        op = Operator(self, desc)
        self.desc.ops.insert(index if desc_index is None else desc_index,
                             desc)
        self.ops.insert(index, op)
        self._infer_shape(desc)
        self.program._bump()
        return op

    def _prepend_op(self, **kwargs) -> Operator:
        return self._insert_op(0, **kwargs)

    def _infer_shape(self, desc: OpDesc):
        if registry.has_op(desc.type):
            info = registry.lookup(desc.type)
            if info.infer_shape is not None:
                info.infer_shape(desc, self)

    def __repr__(self):
        lines = [f"Block(idx={self.idx}, parent={self.parent_idx})"]
        for v in self.vars.values():
            lines.append(f"  {v!r}")
        for op in self.ops:
            lines.append(f"  {op.desc!r}")
        return "\n".join(lines)


def _to_name_map(d) -> Dict[str, List[str]]:
    """Normalize {slot: Variable | [Variable] | name | [name]} to names."""
    out: Dict[str, List[str]] = {}
    if not d:
        return out
    for slot, vs in d.items():
        if vs is None:
            continue
        if not isinstance(vs, (list, tuple)):
            vs = [vs]
        names = []
        for v in vs:
            if isinstance(v, Variable):
                names.append(v.name)
            elif isinstance(v, str):
                names.append(v)
            else:
                raise TypeError(f"bad input/output for slot {slot}: {v!r}")
        out[slot] = names
    return out


class Program:
    """User-visible handle over a ProgramDesc. A model is two Programs:
    a startup program that creates and initializes the persistable
    parameters (run once) and a main program (run per step)."""

    def __init__(self):
        self.desc = ProgramDesc()
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self._current_role = OpRole.FORWARD
        self.random_seed = 0
        self._amp = False
        # bumped on every mutation; keys the executor's memo of the
        # rewritten op lists
        self._version = 0

    @classmethod
    def _from_desc(cls, desc: ProgramDesc) -> "Program":
        """Wrap a deserialized ProgramDesc (Variables rebuilt from the
        var descs, Parameters not distinguished)."""
        p = cls()
        p.desc = desc
        p.blocks = [Block(p, i) for i in range(desc.num_blocks())]
        for blk in p.blocks:
            for name, vd in blk.desc.vars.items():
                v = Variable.__new__(Variable)
                v.block = blk
                v.desc = vd
                blk.vars[name] = v
            blk.ops = [Operator(blk, od) for od in blk.desc.ops]
        return p

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def _bump(self):
        self._version += 1

    @contextlib.contextmanager
    def _role_guard(self, role: OpRole):
        """Ops appended inside carry ``role`` (unless they set one)."""
        old = self._current_role
        self._current_role = role
        try:
            yield
        finally:
            self._current_role = old

    def _optimized_guard(self, param_and_grads):
        """The optimizer's update ops for ``param_and_grads``: OPTIMIZE
        role. (Their op_role_var stamp is the backward's, on the grad's
        producer.)"""
        return self._role_guard(OpRole.OPTIMIZE)

    def _lr_schedule_guard(self):
        return self._role_guard(OpRole.LRSCHED)

    def _backward_role_guard(self):
        return self._role_guard(OpRole.BACKWARD)

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        """A new sub-block (a loop body), made the current block; its
        parent is the current block unless ``parent_idx`` names one."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.desc.append_block(parent)
        b = Block(self, len(self.desc.blocks) - 1)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump()
        return b

    def _rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def global_block(self) -> Block:
        return self.blocks[0]

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy. With for_test=True, drops backward / optimize /
        lr-schedule ops and stamps is_test on ops that carry it."""
        p = Program()
        p.desc = self.desc.clone()
        p.blocks = [Block(p, i) for i in range(p.desc.num_blocks())]
        for i, blk in enumerate(p.blocks):
            src_blk = self.blocks[i]
            for name, desc in blk.desc.vars.items():
                src = src_blk.vars.get(name)
                if isinstance(src, Parameter):
                    v = Parameter.__new__(Parameter)
                    v._copy_attrs_from(src)
                else:
                    v = Variable.__new__(Variable)
                v.block = blk
                v.desc = desc
                blk.vars[name] = v
            blk.ops = [Operator(blk, od) for od in blk.desc.ops]
        if for_test:
            drop_roles = (int(OpRole.BACKWARD) | int(OpRole.OPTIMIZE)
                          | int(OpRole.LRSCHED))
            for blk in p.blocks:
                kept = []
                for op in blk.ops:
                    role = int(op.attr(OP_ROLE_ATTR_NAME) or 0)
                    if role & drop_roles and not role & int(OpRole.LOSS):
                        continue
                    if "is_test" in op.desc.attrs or op.type == "dropout":
                        op.desc.attrs["is_test"] = True
                    kept.append(op)
                blk.ops = kept
                blk.desc.ops = [op.desc for op in kept]
        p.current_block_idx = 0
        p.random_seed = self.random_seed
        p._amp = self._amp
        p._version = self._version
        return p

    def _prune(self, feeds: List[str], targets: List[str]) -> "Program":
        """Backward-slice block 0 to the ops needed for ``targets``
        (reference framework/prune.cc), used by save_inference_model."""
        p = self.clone()
        blk = p.global_block()
        needed = set(targets)
        kept = []
        for op in reversed(blk.ops):
            if set(op.output_arg_names) & needed:
                kept.append(op)
                needed |= set(op.input_arg_names)
        kept.reverse()
        blk.ops = kept
        blk.desc.ops = [op.desc for op in kept]
        referenced = set(feeds) | set(targets)
        for op in kept:
            referenced |= set(op.input_arg_names) | set(op.output_arg_names)
        for name in list(blk.vars):
            if name not in referenced:
                del blk.vars[name]
                blk.desc.vars.pop(name, None)
        p._bump()
        return p

    def to_string(self) -> str:
        return "\n".join(repr(b) for b in self.blocks)

    __repr__ = to_string


_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def name_scope(prefix: str):
    """A cosmetic name scope (the reference's, for debugging and
    visualization): names and programs are unchanged, as in the JAX
    package."""
    yield


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_start = None
    if startup_program is not None:
        old_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_start is not None:
            switch_startup_program(old_start)

from .desc import BlockDesc, OpDesc, ProgramDesc, VarDesc  # noqa: F401
from .types import (DataType, OpRole, VarType, convert_dtype,  # noqa: F401
                    dtype_to_numpy, dtype_to_torch)


class EOFException(Exception):
    """Raised by the ``read`` op when its reader is exhausted (the
    reference's core.EOFException); the training loop catches it and
    calls ``reset()``."""

"""Operator library: eager PyTorch emitters per op family. Importing this
package registers everything."""

from . import kernels_tensor  # noqa: F401
from . import kernels_math  # noqa: F401
from . import kernels_nn  # noqa: F401
from . import kernels_sequence  # noqa: F401
from . import kernels_host  # noqa: F401
from . import kernels_reader  # noqa: F401
from . import kernels_control  # noqa: F401
from . import kernels_optim  # noqa: F401
from . import kernels_fused  # noqa: F401
from . import kernels_image  # noqa: F401
from . import kernels_cache  # noqa: F401
from . import kernels_rnn  # noqa: F401
from . import kernels_search  # noqa: F401
from . import flash_attention  # noqa: F401

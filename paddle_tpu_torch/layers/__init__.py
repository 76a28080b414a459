from . import control_flow, detection, io, math_op_patch, nn  # noqa: F401
from . import ops  # noqa: F401
from . import rnn, tensor  # noqa: F401
from . import learning_rate_scheduler  # noqa: F401
from .control_flow import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403

"""paddle_tpu_torch: the Fluid-class framework of ``paddle_tpu`` ported to
PyTorch and CUDA for an NVIDIA H100.

The same surface as the JAX package: build a Program with the layers DSL,
train it with an optimizer's ``minimize`` on an Executor (optionally
through ``CompiledProgram`` and a ``BuildStrategy`` pass pipeline), save
it as an inference model and serve it through
``inference.create_paddle_predictor`` (``AnalysisConfig`` adds the IR
passes and bf16). ``elastic.ElasticTrainer`` runs a training loop over a
``reader.DataLoader`` with checkpoints on a cadence and a bit-exact
resume. Programs, parameter files and checkpoints are byte-compatible
with the JAX package's. Entry points run on the card (``CUDAPlace(0)``)
unless the caller asks for ``CPUPlace()``; the ``flash_attention`` op and
its grad run hand-written CUDA kernels on the card. ``monitor`` (metrics,
step telemetry, the live HTTP plane, flight records), ``profiler`` and
the lazily imported ``profiling`` package (per-op device time of eager
and captured runs, the memory footprint and budget) observe it.
"""

from . import core, ops, registry  # noqa: F401  (ops registers emitters)
from . import initializer, io, layers, nets, optimizer  # noqa: F401
from . import backward, clip, contrib, ir, regularizer  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .executor import (Executor, FetchHandle, Scope,  # noqa: F401
                       global_scope, scope_guard)
from .framework import (Block, Operator, Parameter,  # noqa: F401
                        Program, Variable, default_main_program,
                        default_startup_program, name_scope, program_guard)
from .backward import append_backward, calc_gradient  # noqa: F401
from .core.types import DataType, OpRole, VarType  # noqa: F401
from .layer_helper import (LayerHelper, ParamAttr,  # noqa: F401
                           WeightNormParamAttr)
from .layers.nn import one_hot  # noqa: F401
from .place import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401
                    core_device_count, cpu_places, cuda_pinned_places,
                    cuda_places)
from .utils.flags import FLAGS, get_flags, set_flags  # noqa: F401
from . import inference, models  # noqa: F401
from . import average, data_feeder, elastic, lod_tensor  # noqa: F401
from . import dataset, imperative, metrics, reader  # noqa: F401
from . import debugger, monitor, profiler  # noqa: F401
from .average import WeightedAverage  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .lod_tensor import (LoDTensor, Tensor, create_lod_tensor,  # noqa: F401
                         create_random_int_lodtensor)
from .reader import batch  # noqa: F401
from .utils import unique_name  # noqa: F401

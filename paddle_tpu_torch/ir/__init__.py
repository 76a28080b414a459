"""Graph IR and pass infrastructure (counterpart of ``paddle_tpu/ir/``;
reference paddle/fluid/framework/ir/): the reader/writer graph view,
the pattern detector, the registry passes AnalysisPredictor applies and
the BuildStrategy pipeline (ir/pipeline.py) the executor runs on a
CompiledProgram's live op list, and the program verifier (ir/verify.py)
it runs under ``verify_passes``. ``shard_analyze.py`` is not ported
(ROADMAP A12)."""

from .graph import Graph
from .passes import (Pass, PASS_REGISTRY, apply_passes, get_pass,
                     register_pass)
from . import analyze
from . import pipeline
from . import verify
from .verify import (Diagnostic, PassVerifyError, ProgramVerifyError,
                     VerifyReport, verify_program)

__all__ = ["Graph", "Pass", "PASS_REGISTRY", "apply_passes", "get_pass",
           "register_pass", "analyze", "pipeline", "verify", "Diagnostic",
           "VerifyReport", "ProgramVerifyError", "PassVerifyError",
           "verify_program"]

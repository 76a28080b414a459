"""Graph IR and pass infrastructure (counterpart of ``paddle_tpu/ir/``;
reference paddle/fluid/framework/ir/): the reader/writer graph view,
the pattern detector, the registry passes AnalysisPredictor applies and
the BuildStrategy pipeline (ir/pipeline.py) the executor runs on a
CompiledProgram's live op list. ``verify.py`` and ``shard_analyze.py``
are not ported (ROADMAP)."""

from .graph import Graph
from .passes import (Pass, PASS_REGISTRY, apply_passes, get_pass,
                     register_pass)
from . import analyze
from . import pipeline

__all__ = ["Graph", "Pass", "PASS_REGISTRY", "apply_passes", "get_pass",
           "register_pass", "analyze", "pipeline"]

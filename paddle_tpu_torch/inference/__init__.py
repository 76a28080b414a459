"""Inference engine (counterpart of ``paddle_tpu/inference``): the
predictors, the serving front, the inference transpiler and, from
``inference.generation``, the decode engine and its serving front
(``DecodeEngine``, ``GenerationPredictor``, ``GenerationSpec``,
``SamplingParams``). The JAX package's ``CppPredictor`` waits for ROADMAP
A13."""

from .api import (AnalysisConfig, AnalysisPredictor, NativeConfig,
                  NativePredictor, PaddleTensor, create_paddle_predictor)
from .generation import (DecodeEngine, GenerationPredictor, GenerationSpec,
                         SamplingParams)
from .serving import (BatchingPredictor, BucketedPredictor, BucketLadder,
                      CircuitOpen, DeadlineExceeded, Overloaded,
                      ServingError)
from .transpiler import InferenceTranspiler

__all__ = ["AnalysisConfig", "AnalysisPredictor", "NativeConfig",
           "NativePredictor", "PaddleTensor", "create_paddle_predictor",
           "InferenceTranspiler", "BucketLadder", "BucketedPredictor",
           "BatchingPredictor", "ServingError", "DeadlineExceeded",
           "Overloaded", "CircuitOpen", "DecodeEngine", "GenerationPredictor",
           "GenerationSpec", "SamplingParams"]

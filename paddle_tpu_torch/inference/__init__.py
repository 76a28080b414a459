"""Inference engine (counterpart of ``paddle_tpu/inference``): the
predictors, the serving front and the inference transpiler. The JAX
package's ``CppPredictor`` waits for ROADMAP A13 and its generation
names (``DecodeEngine``, ``GenerationPredictor``, ``GenerationSpec``,
``SamplingParams``) for A7."""

from .api import (AnalysisConfig, AnalysisPredictor, NativeConfig,
                  NativePredictor, PaddleTensor, create_paddle_predictor)
from .serving import (BatchingPredictor, BucketedPredictor, BucketLadder,
                      CircuitOpen, DeadlineExceeded, Overloaded,
                      ServingError)
from .transpiler import InferenceTranspiler

__all__ = ["AnalysisConfig", "AnalysisPredictor", "NativeConfig",
           "NativePredictor", "PaddleTensor", "create_paddle_predictor",
           "InferenceTranspiler", "BucketLadder", "BucketedPredictor",
           "BatchingPredictor", "ServingError", "DeadlineExceeded",
           "Overloaded", "CircuitOpen"]

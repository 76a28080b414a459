from .api import (AnalysisConfig, AnalysisPredictor,  # noqa: F401
                  NativeConfig, NativePredictor, PaddleTensor,
                  create_paddle_predictor)

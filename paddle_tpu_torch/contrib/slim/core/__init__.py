"""slim.core: the compression controller, the strategy base class and
the yaml config (reference contrib/slim/core/)."""

from .compress_pass import CompressPass, Context
from .config import ConfigFactory
from .pass_builder import build_compressor
from .strategy import Strategy

__all__ = ["CompressPass", "Context", "ConfigFactory",
           "build_compressor", "Strategy"]

from . import decoder, mixed_precision, quantize, slim  # noqa: F401
from .quantize import QuantizeTranspiler  # noqa: F401

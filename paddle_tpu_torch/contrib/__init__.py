from . import decoder, mixed_precision  # noqa: F401

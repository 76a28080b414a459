from . import mixed_precision  # noqa: F401

from . import resnet, transformer  # noqa: F401

from . import bert, resnet, transformer  # noqa: F401

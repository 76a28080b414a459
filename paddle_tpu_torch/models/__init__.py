from . import bert, machine_translation, resnet, transformer  # noqa: F401

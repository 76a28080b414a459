"""The CompressPass builder (reference contrib/slim/core/pass_builder.py:21
build_compressor): a CompressPass from a yaml config (a path or a dict)
with the runtime pieces (place, reader, scope, metrics) attached."""

from __future__ import annotations

from .compress_pass import CompressPass
from .config import ConfigFactory

__all__ = ["build_compressor"]


def build_compressor(place=None, data_reader=None, data_feeder=None,
                     scope=None, metrics=None, epoch=None, config=None,
                     program_exe=None):
    if config is not None:
        comp_pass = ConfigFactory(config).get_compress_pass()
        if comp_pass is None:
            raise ValueError("config has no compress_pass entry")
    else:
        comp_pass = CompressPass()
    if place is not None:
        comp_pass.place = place
    comp_pass.data_reader = data_reader
    comp_pass.data_feeder = data_feeder
    comp_pass.scope = scope
    comp_pass.metrics = metrics
    if epoch is not None:
        comp_pass.epoch = epoch
    comp_pass.program_exe = program_exe
    return comp_pass

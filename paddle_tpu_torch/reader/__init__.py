"""Readers (counterpart of ``paddle_tpu/reader``): the composable
decorators of the reference's python/paddle/reader/decorator.py, and the
DataLoader that copies batches to the device ahead of the step."""

from .data_loader import DataLoader
from .decorator import (ComposeNotAligned, Fake, PipeReader,
                        multiprocess_reader,
                        batch, buffered, cache, chain, compose, firstn,
                        map_readers, shuffle, xmap_readers)

__all__ = ["DataLoader",
           "batch", "buffered", "cache", "chain", "compose", "firstn",
           "map_readers", "shuffle", "xmap_readers", "ComposeNotAligned",
           "Fake", "PipeReader", "multiprocess_reader"]

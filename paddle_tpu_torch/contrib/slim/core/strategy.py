"""The strategy base class (reference contrib/slim/core/strategy.py:18):
callbacks the CompressPass controller calls around the training loop."""

__all__ = ["Strategy"]


class Strategy:
    """Base class of the compression strategies. A strategy is active on
    epochs [start_epoch, end_epoch) and may hook any of the six callback
    points; the Context carries the graph, the scope, the executors and
    the epoch and batch counters."""

    def __init__(self, start_epoch=0, end_epoch=10):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch

    def on_compress_begin(self, context):
        pass

    def on_epoch_begin(self, context):
        pass

    def on_epoch_end(self, context):
        pass

    def on_batch_begin(self, context):
        pass

    def on_batch_end(self, context):
        pass

    def on_compress_end(self, context):
        pass

"""Predictor API (counterpart of ``paddle_tpu/inference/api.py``;
reference inference/api/paddle_api.h).

``NativeConfig(model_dir)`` serves on ``cuda:0`` unless ``use_gpu=False``
is passed (the reference Fluid's knob; the JAX package calls it
``use_xla``). With no CUDA device and no explicit CPU request the
predictor raises instead of running on the host.

``AnalysisConfig`` adds the IR pass list (``DEFAULT_PASSES``, the JAX
package's) and bf16 autocast; ``create_paddle_predictor`` gives an
``AnalysisPredictor`` for it, which rewrites the loaded program with the
passes and then flags it for bf16. With the serving knobs set
(``enable_shape_bucketing``, ``enable_request_coalescing``) the predictor
comes back wrapped in ``serving.BucketedPredictor`` and
``serving.BatchingPredictor``. ``create_paddle_predictor`` also starts
the monitor's HTTP plane when ``FLAGS.monitor_port`` is set
(``monitor.maybe_serve_http``), as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import executor as _executor
from .. import io as _io
from ..place import CPUPlace, CUDAPlace


class PaddleTensor:
    """Named tensor (paddle_api.h ``PaddleTensor``). A fetch result stays
    on the device until ``.data`` / ``as_ndarray()`` is first read, which
    copies it to the host once; ``as_tensor()`` hands out the device
    tensor without a copy."""

    __slots__ = ("name", "_tensor", "_array")

    def __init__(self, data, name: str = ""):
        self.name = name
        self._tensor = (data if isinstance(data, torch.Tensor)
                        else torch.from_numpy(np.array(data)))
        self._array = None

    @property
    def data(self) -> np.ndarray:
        if self._array is None:
            self._array = _executor._to_numpy(self._tensor)
        return self._array

    def as_ndarray(self) -> np.ndarray:
        return self.data

    def as_tensor(self) -> torch.Tensor:
        return self._tensor

    @property
    def shape(self):
        return list(self._tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._tensor.dtype


class NativeConfig:
    """Where the model lives and which device serves it."""

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None,
                 use_gpu: bool = True, device: int = 0):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self.use_gpu = use_gpu
        self.device = device
        # serving knobs (inference/serving.py): bucket ladder and request
        # coalescing; create_paddle_predictor wraps accordingly
        self.bucket_config: Optional[dict] = None
        self.coalesce_config: Optional[dict] = None

    def enable_shape_bucketing(self, batch_buckets=None, seq_dim=None,
                               seq_buckets=None, seq_feeds=None,
                               warmup_workers: int = 4):
        """Serve any request batch size from a bounded ladder of shape
        buckets (powers of two by default), each one plan (a CUDA graph
        on the card): the batch dim pads UP to the nearest bucket,
        oversize batches chunk at the top bucket, outputs slice back to
        the true rows. One declared dynamic trailing dim (e.g. seqlen)
        buckets too via seq_dim/seq_buckets. ``warmup_workers`` warms that
        many ladder cells concurrently in warmup() (1 = serial). See
        serving.BucketedPredictor."""
        self.bucket_config = {"batch_buckets": batch_buckets,
                              "seq_dim": seq_dim,
                              "seq_buckets": seq_buckets,
                              "seq_feeds": seq_feeds,
                              "warmup_workers": warmup_workers}
        return self

    def enable_request_coalescing(self, max_batch_size: int = 64,
                                  batch_timeout_us: int = 2000,
                                  max_queue_rows: Optional[int] = 4096,
                                  shed_policy: str = "reject-new",
                                  default_deadline_ms: Optional[float] = None,
                                  dispatch_retries: int = 2,
                                  retry_backoff_ms: float = 10.0,
                                  breaker_threshold: int = 5,
                                  breaker_reset_ms: float = 1000.0):
        """Coalesce concurrent run() calls into one padded device call
        (micro-batching): a dispatcher thread gathers up to
        max_batch_size rows, waiting at most batch_timeout_us for
        co-requests, and fans rows back per request via futures.

        Resilience knobs (serving.BatchingPredictor): ``max_queue_rows``
        bounds the queue (None = unbounded) with ``shed_policy``
        'reject-new' (raise Overloaded at the caller) or 'drop-oldest'
        (fail the oldest queued futures); ``default_deadline_ms`` stamps
        every request lacking an explicit submit(deadline_ms=)
        (DeadlineExceeded if still queued at expiry);
        ``dispatch_retries``/``retry_backoff_ms`` retry a failed device
        call with capped exponential backoff; ``breaker_threshold``
        consecutive dispatch failures open the circuit breaker
        (CircuitOpen fail-fast, half-open probe after
        ``breaker_reset_ms``; 0 disables)."""
        self.coalesce_config = {
            "max_batch_size": int(max_batch_size),
            "batch_timeout_us": int(batch_timeout_us),
            "max_queue_rows": max_queue_rows,
            "shed_policy": shed_policy,
            "default_deadline_ms": default_deadline_ms,
            "dispatch_retries": int(dispatch_retries),
            "retry_backoff_ms": float(retry_backoff_ms),
            "breaker_threshold": int(breaker_threshold),
            "breaker_reset_ms": float(breaker_reset_ms)}
        return self


class AnalysisConfig(NativeConfig):
    """analysis_predictor.h AnalysisConfig analog: the IR pass list and
    bf16 autocast."""

    DEFAULT_PASSES = ("infer_clean_graph_pass", "is_test_pass",
                      "identity_scale_op_clean_pass",
                      "conv_affine_channel_fuse_pass",
                      "conv_bn_fuse_pass",
                      "conv_elementwise_add_act_fuse_pass",
                      "conv_elementwise_add2_act_fuse_pass",
                      "conv_elementwise_add_fuse_pass",
                      "embedding_fc_lstm_fuse_pass",
                      "fc_fuse_pass", "fc_gru_fuse_pass",
                      "fc_lstm_fuse_pass",
                      "repeated_fc_relu_fuse_pass",
                      "seqconv_eltadd_relu_fuse_pass",
                      "squared_mat_sub_fuse_pass",
                      "seqpool_concat_fuse_pass",
                      "transpose_flatten_concat_fuse_pass")

    def __init__(self, model_dir: Optional[str] = None, **kw):
        super().__init__(model_dir, **kw)
        self.ir_optim = True
        self.use_bf16 = False
        self.passes: List[str] = list(self.DEFAULT_PASSES)

    def switch_ir_optim(self, flag: bool = True):
        self.ir_optim = flag
        return self

    def enable_bf16(self, flag: bool = True):
        """bf16 autocast for the loaded program's products (the cast
        points of ``contrib.mixed_precision``): the GEMMs and the flash
        attention kernel run on bf16 operands. Applied in _optimize."""
        self.use_bf16 = flag
        return self

    def pass_builder_set(self, passes: Sequence[str]):
        self.passes = list(passes)
        return self


class NativePredictor:
    """api_impl.h NativePaddlePredictor analog: load once, run per
    request. On the card the executor captures each request signature
    (feed shapes and dtypes) in a CUDA graph at its second request and
    replays it for the later ones; ``close()`` releases the graphs."""

    def __init__(self, config: NativeConfig):
        self._config = config
        self._place = CUDAPlace(config.device) if config.use_gpu else CPUPlace()
        self._scope = _executor.Scope()
        self._exe = _executor.Executor(self._place)
        with _executor.scope_guard(self._scope):
            self._program, self._feed_names, self._fetch_vars = \
                _io.load_inference_model(
                    config.model_dir, self._exe,
                    model_filename=config.prog_file,
                    params_filename=config.params_file)
        self._fetch_names = [v.name for v in self._fetch_vars]
        self._optimize()

    def _optimize(self):
        pass

    @property
    def device(self) -> torch.device:
        return self._exe.device

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def run(self, inputs: Union[Dict[str, np.ndarray],
                                Sequence[PaddleTensor]]) -> List[PaddleTensor]:
        """One inference call. Outputs stay on the device until read."""
        if isinstance(inputs, dict):
            feed = dict(inputs)
        else:
            feed = {t.name or self._feed_names[i]: t.as_tensor()
                    for i, t in enumerate(inputs)}
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError(f"missing inputs: {missing}")
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_names,
                             return_numpy=False, scope=self._scope)
        return [PaddleTensor(o.device_value(), n)
                for n, o in zip(self._fetch_names, outs)]

    def clone(self):
        """paddle_api.h:186 Clone(): a predictor sharing this one's scope,
        executor and program, so its weights and warm plans too; it may
        run on another thread at the same time (the executor is
        thread-safe)."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        return new

    def close(self):
        """Release the captured graphs of this predictor's program."""
        self._exe.close()


class AnalysisPredictor(NativePredictor):
    """analysis_predictor.h:44 analog: the loaded program rewritten by
    the config's passes (the fetches protected), then flagged for bf16
    when the config asks."""

    def _optimize(self):
        from .. import ir
        from ..contrib import mixed_precision
        cfg = self._config
        if cfg.ir_optim:
            ir.apply_passes(self._program, cfg.passes, scope=self._scope,
                            protected=self._fetch_names)
        if cfg.use_bf16:
            mixed_precision.decorate(self._program)


def create_paddle_predictor(config: NativeConfig):
    """paddle_api.h CreatePaddlePredictor analog: an AnalysisPredictor
    for an AnalysisConfig, else a NativePredictor; with the serving knobs
    set, wrapped in the bucketed and the micro-batching serving layers
    (inference/serving.py), with the same run() surface."""
    if isinstance(config, AnalysisConfig):
        pred = AnalysisPredictor(config)
    else:
        pred = NativePredictor(config)
    if config.bucket_config is not None:
        from . import serving
        pred = serving.BucketedPredictor(pred, **config.bucket_config)
    if config.coalesce_config is not None:
        from . import serving
        pred = serving.BatchingPredictor(pred, **config.coalesce_config)
    # the live plane: with FLAGS.monitor_port set, bringing up a
    # predictor brings up /metrics, /healthz, /vars, ... (the serving
    # wrappers registered their health() callbacks above)
    from .. import monitor as _monitor
    _monitor.maybe_serve_http()
    return pred

"""contrib.decoder: seq2seq decoder abstractions (counterpart of
``paddle_tpu/contrib/decoder``): ``BeamSearchDecoder`` builds a dense
beam search in a ``While`` loop, and ``GenerationDecoder`` /
``dynamic_decode`` decode on the KV-cache ``DecodeEngine``, and
``TrainingDecoder`` trains a ``StateCell`` teacher-forced over
``DynamicRNN``."""

from .beam_search_decoder import (BeamSearchDecoder, GenerationDecoder,
                                  InitState, StateCell, TrainingDecoder,
                                  dynamic_decode)

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder", "GenerationDecoder", "dynamic_decode"]

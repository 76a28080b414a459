"""Seq2seq decoder abstractions (counterpart of
``paddle_tpu/contrib/decoder/beam_search_decoder.py``; reference
contrib/decoder/beam_search_decoder.py: InitState :43, StateCell :159,
TrainingDecoder :384, BeamSearchDecoder :523).

- ``BeamSearchDecoder`` keeps the beam dense: a fixed [batch*beam] row
  layout inside a ``While`` (bounded: its counter loop gets a static
  trip bound, so on the card the loop is captured with the rest of the
  program), with finished hypotheses frozen by the ``beam_search`` op.
  init_ids/init_scores and every state and static input arrive already
  tiled over the beam ([batch*beam, ...], see
  models/machine_translation._tile_beam), and the output projection can
  be given parameter names, so that a decode program shares trained
  weights.
- ``GenerationDecoder`` and ``dynamic_decode`` keep the decoder surface
  over :class:`~paddle_tpu_torch.inference.generation.DecodeEngine`:
  prefill through the bucket ladder, then captured decode chunks.
- ``TrainingDecoder`` rides ``DynamicRNN``: the teacher-forced decode is
  one ``recurrent`` op, a loop over the static T that the executor runs
  (and captures) with the rest of the program; a ``StateCell`` inside it
  turns its states into the loop's memories at their first use.
"""

from __future__ import annotations

from ... import layers

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder", "GenerationDecoder", "dynamic_decode"]


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState:
    """Initial hidden state: an explicit variable, or a constant tensor
    shaped like `init_boot` (batch dim) x `shape` (rest)."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "InitState needs `init` or `init_boot` to infer shape")
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape, dtype=dtype)
        self._need_reorder = need_reorder

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class StateCell:
    """Named step inputs + named hidden states + one updater function.

    The updater reads inputs and states with get_input/get_state and
    writes new states with set_state; the owning decoder decides how a
    state is committed (a DynamicRNN memory update, or a reorder by the
    beam's parents and an assign)."""

    def __init__(self, inputs, states, out_state, name=None):
        self._cur_states = {}
        self._state_names = []
        self._init_states = {}
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError("state must be an InitState object")
            self._init_states[state_name] = state
            self._cur_states[state_name] = state.value
            self._state_names.append(state_name)
        self._inputs = dict(inputs)
        self._next_states = {}
        self._state_updater = None
        self._out_state = out_state
        self._decoder = None
        self._memories = None   # training: state name -> rnn pre-state
        if out_state not in self._cur_states:
            raise ValueError("out_state must be one state in states")

    # -- decoder handshake ------------------------------------------------
    def _enter_decoder(self, decoder):
        if self._decoder is not None:
            raise ValueError("StateCell has already entered a decoder")
        self._decoder = decoder

    def _leave_decoder(self, decoder):
        if self._decoder is not decoder:
            raise ValueError("StateCell is not in this decoder")
        self._decoder = None
        self._memories = None

    def _in_training_block(self):
        return (self._decoder is not None
                and self._decoder.type == _DecoderType.TRAINING
                and self._decoder._in_block)

    def _materialize_memories(self):
        """Training: the InitStates become DynamicRNN memories at the
        first access inside the block."""
        if self._memories is not None:
            return
        rnn = self._decoder.dynamic_rnn
        self._memories = {}
        for name in self._state_names:
            pre = rnn.memory(init=self._init_states[name].value)
            self._memories[name] = pre
            self._cur_states[name] = pre

    # -- user API ---------------------------------------------------------
    def get_state(self, state_name):
        if self._in_training_block():
            self._materialize_memories()
        if state_name not in self._cur_states:
            raise ValueError(f"unknown state {state_name!r}")
        return self._next_states.get(state_name,
                                     self._cur_states[state_name])

    def get_input(self, input_name):
        if input_name not in self._inputs \
                or self._inputs[input_name] is None:
            raise ValueError(f"input {input_name!r} has not been set")
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        if state_name not in self._cur_states:
            raise ValueError(f"unknown state {state_name!r}")
        self._next_states[state_name] = state_value

    def state_updater(self, updater):
        self._state_updater = updater

        def _decorator(state_cell):
            if state_cell is not self:
                raise TypeError("updater must take this StateCell")
            updater(state_cell)

        return _decorator

    def compute_state(self, inputs):
        """Run the registered updater against this step's inputs."""
        if self._in_training_block():
            self._materialize_memories()
        for name, value in inputs.items():
            if name not in self._inputs:
                raise ValueError(f"unknown step input {name!r}")
            self._inputs[name] = value
        if self._state_updater is None:
            raise ValueError("no state_updater registered")
        self._state_updater(self)

    def update_states(self):
        """Commit this step's set_state() values: as the DynamicRNN's
        memory updates in training, else for the beam decoder to reorder
        and assign after its selection."""
        if (self._decoder is not None
                and self._decoder.type == _DecoderType.TRAINING):
            rnn = self._decoder.dynamic_rnn
            for name, new in self._next_states.items():
                rnn.update_memory(self._memories[name], new)
        else:
            for name, new in self._next_states.items():
                self._cur_states[name] = new
        self._next_states = {}

    def out_state(self):
        return self.get_state(self._out_state)


class TrainingDecoder:
    """Teacher-forced decoder over DynamicRNN (one ``recurrent`` op).

    ``length`` holds the per-row target lengths of the padded batch (the
    stand-in for the reference's LoD-driven step count)."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, length=None, name=None):
        self._status = TrainingDecoder.BEFORE_DECODER
        self._dynamic_rnn = layers.DynamicRNN(length=length, name=name)
        self._type = _DecoderType.TRAINING
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._in_block = False

    def block(self):
        if self._status != TrainingDecoder.BEFORE_DECODER:
            raise ValueError("decoder.block() can only be invoked once")
        self._status = TrainingDecoder.IN_DECODER
        return _TrainingDecoderGuard(self)

    @property
    def state_cell(self):
        self._assert_in_block("state_cell")
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @property
    def type(self):
        return self._type

    def step_input(self, x):
        self._assert_in_block("step_input")
        return self._dynamic_rnn.step_input(x)

    def static_input(self, x):
        self._assert_in_block("static_input")
        return self._dynamic_rnn.static_input(x)

    def output(self, *outputs):
        self._assert_in_block("output")
        self._dynamic_rnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError("visit the decoder output outside block()")
        return self._dynamic_rnn(*args, **kwargs)

    def _assert_in_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError(
                f"{method} must be called inside decoder.block()")


class _TrainingDecoderGuard:
    def __init__(self, decoder):
        self._decoder = decoder
        self._rnn_guard = decoder._dynamic_rnn.block()

    def __enter__(self):
        self._rnn_guard.__enter__()
        self._decoder._in_block = True
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._decoder._in_block = False
        out = self._rnn_guard.__exit__(exc_type, exc_val, exc_tb)
        if exc_type is None:
            self._decoder._status = TrainingDecoder.AFTER_DECODER
            self._decoder._state_cell._leave_decoder(self._decoder)
        return out


class BeamSearchDecoder:
    """Inference-time beam search over a While loop, dense beams.

    init_ids/init_scores: [batch*beam] start tokens and accumulated
    log-scores (give non-first rows a very negative score so the search
    starts from one live row per batch row). States / input_var_dict
    entries: already tiled to [batch*beam, ...]. `param_attr`/`bias_attr`
    name the output projection so it can share the trained softmax
    weights."""

    def __init__(self, state_cell, init_ids, init_scores,
                 target_dict_dim, word_dim, input_var_dict=None,
                 topk_size=50, sparse_emb=True, max_len=100,
                 beam_size=1, end_id=1, name=None, emb_param_attr=None,
                 param_attr=None, bias_attr=None):
        self._type = _DecoderType.BEAM_SEARCH
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._topk_size = min(topk_size, target_dict_dim)
        self._sparse_emb = sparse_emb
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._emb_param_attr = emb_param_attr
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._decoded = False
        self._in_block = False

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        return self._state_cell

    def decode(self):
        """Build the decode loop."""
        if self._decoded:
            raise ValueError("decode() can only be invoked once")
        self._decoded = True
        dmax, beam, end_id = self._max_len, self._beam_size, self._end_id

        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = layers.fill_constant(shape=[1], dtype="int64",
                                     value=dmax)
        # [dmax, batch*beam] histories for the final backtrack
        ids_hist = layers.fill_constant_batch_size_like(
            input=self._init_ids, shape=[dmax, 1], dtype="int64",
            value=end_id, input_dim_idx=0, output_dim_idx=1)
        par_hist = layers.fill_constant_batch_size_like(
            input=self._init_ids, shape=[dmax, 1], dtype="int32",
            value=0, input_dim_idx=0, output_dim_idx=1)
        pre_ids = layers.assign(self._init_ids)
        pre_scores = layers.assign(self._init_scores)
        # loop-carried copies of the states (assign-updated per step)
        state_vars = {n: layers.assign(self._state_cell._cur_states[n])
                      for n in self._state_cell._state_names}

        cond = layers.less_than(x=i, y=limit)
        w = layers.While(cond=cond)
        self._in_block = True
        with w.block():
            emb = layers.embedding(
                pre_ids, size=[self._target_dict_dim, self._word_dim],
                is_sparse=self._sparse_emb,
                param_attr=self._emb_param_attr)
            feed = {}
            for name in self._state_cell._inputs:
                feed[name] = self._input_var_dict.get(name, emb)
            for name, var in state_vars.items():
                self._state_cell._cur_states[name] = var
            self._state_cell.compute_state(inputs=feed)

            current_state = self._state_cell.out_state()
            scores = layers.fc(current_state,
                               size=self._target_dict_dim,
                               act="softmax",
                               param_attr=self._param_attr,
                               bias_attr=self._bias_attr)
            topk_scores, topk_ids = layers.topk(scores,
                                                k=self._topk_size)
            sel_ids, sel_scores, parent = layers.beam_search(
                pre_ids, pre_scores, topk_ids, topk_scores,
                beam_size=beam, end_id=end_id, is_accumulated=False)

            # commit, and reorder every state by its parent row
            self._state_cell.update_states()
            for name, var in state_vars.items():
                layers.assign(
                    layers.gather(self._state_cell._cur_states[name],
                                  parent), var)
            layers.assign(sel_ids, pre_ids)
            layers.assign(sel_scores, pre_scores)
            layers.array_write(sel_ids, i, array=ids_hist)
            layers.array_write(parent, i, array=par_hist)
            layers.increment(i, value=1, in_place=True)
            layers.less_than(x=i, y=limit, cond=cond)
        self._in_block = False
        self._state_cell._leave_decoder(self)

        self._translation_ids = layers.beam_search_decode(
            ids_hist, par_hist, end_id=end_id)
        self._translation_scores = pre_scores

    def __call__(self):
        if not self._decoded:
            raise ValueError("call decode() before reading the result")
        return self._translation_ids, self._translation_scores


class GenerationDecoder:
    """The decode entry point over the KV-cache generation engine.

    Construct from a :class:`GenerationSpec` (models/transformer.build_lm)
    and call :meth:`decode` with start token ids; the engine prefills
    through its bucket ladder and decodes in captured chunks. Greedy is
    beam_size=1 beam search; temperature/top-k sampling replaces the
    stochastic ``sampling_id`` decode idiom. Runs on the card unless
    ``place`` is ``CPUPlace()``."""

    def __init__(self, spec, place=None, scope=None, max_len=32,
                 end_id=None, prompt_buckets=(8, 16, 32),
                 new_token_buckets=(8, 16, 32),
                 slot_buckets=(1, 2, 4, 8)):
        from ...inference.generation import DecodeEngine
        if end_id is not None and end_id != spec.eos_id:
            raise ValueError(
                f"end_id {end_id} disagrees with the spec's eos_id "
                f"{spec.eos_id}; the engine stops on the spec's id")
        self._max_len = int(max_len)
        self.engine = DecodeEngine(
            spec, place=place, scope=scope,
            prompt_buckets=prompt_buckets,
            new_token_buckets=new_token_buckets,
            slot_buckets=slot_buckets)

    def decode(self, init_ids, max_len=None, sampling=None):
        """One continuation per row of ``init_ids`` (a list of 1-D prompt
        arrays, or a [B, T] batch): a list of int32 token arrays, EOS
        included when hit."""
        import numpy as np
        ids = np.asarray(init_ids) if not isinstance(init_ids, list) \
            else init_ids
        if not isinstance(ids, list):
            if ids.ndim == 1:
                ids = [ids]
            else:
                ids = [row for row in ids.reshape(ids.shape[0], -1)]
        return self.engine.generate(
            ids, max_new_tokens=(self._max_len if max_len is None
                                 else int(max_len)),
            sampling=sampling)


def dynamic_decode(spec, init_ids, max_len=32, sampling=None,
                   place=None, scope=None, **engine_kw):
    """One-call greedy or sampled decode on the generation engine (see
    :class:`GenerationDecoder`)."""
    return GenerationDecoder(spec, place=place, scope=scope,
                             max_len=max_len, **engine_kw
                             ).decode(init_ids, sampling=sampling)

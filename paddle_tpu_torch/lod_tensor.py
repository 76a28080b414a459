"""LoDTensor on the host (counterpart of ``paddle_tpu/lod_tensor.py``;
reference lod_tensor.py, create_lod_tensor).

The framework's convention for ragged data is padded [B, T, ...] plus
lengths; the reference's LoD tensors are a feed-side convenience, so
reference-style data code runs unchanged: ``create_lod_tensor(rows)``
holds the flat data and the lengths and converts to the padded
convention with ``to_padded()``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LoDTensor", "Tensor", "create_lod_tensor",
           "create_random_int_lodtensor", "beam_decode_to_lod"]


def beam_decode_to_lod(sentence_ids, batch_size, beam_width, end_id,
                       sentence_scores=None):
    """Structure dense beam_search_decode output as the reference's
    2-level LoD (beam_search_decode_op.cc: SentenceIds LoD level 1
    groups the beam hypotheses of each source item, level 2 delimits
    each hypothesis' tokens; framework/lod_tensor.h:58).

    ``sentence_ids``: the op's dense [batch*beam, T] output; each
    hypothesis is its row prefix up to and INCLUDING the first
    ``end_id`` (rows that never emit end_id keep all T tokens).
    Returns (ids LoDTensor, scores LoDTensor | None); both carry
    recursive_seq_lens [[beam]*batch, per-hypothesis lengths]."""
    ids = np.asarray(sentence_ids)
    rows, t = ids.shape
    if rows != batch_size * beam_width:
        raise ValueError(
            f"sentence_ids has {rows} rows != batch {batch_size} * "
            f"beam {beam_width}")
    lens = []
    flat = []
    for r in range(rows):
        hit = np.flatnonzero(ids[r] == end_id)
        l = int(hit[0]) + 1 if hit.size else t
        lens.append(l)
        flat.append(ids[r, :l])
    outer = [beam_width] * batch_size
    ids_lod = LoDTensor(np.concatenate(flat), [outer, lens])
    scores_lod = None
    if sentence_scores is not None:
        # one score per hypothesis: level-2 lengths are all 1 (the
        # reference broadcasts per-token scores; final-only is this
        # op's dense contract, noted delta)
        scores_lod = LoDTensor(
            np.asarray(sentence_scores).reshape(-1),
            [outer, [1] * rows])
    return ids_lod, scores_lod


class LoDTensor:
    """Flat data + level-0 sequence lengths (framework/lod_tensor.h
    analog, host-side)."""

    def __init__(self, data, recursive_seq_lens=None):
        self._data = np.asarray(data)
        self._lens = ([list(l) for l in recursive_seq_lens]
                      if recursive_seq_lens else [])

    def set(self, data, place=None):
        self._data = np.asarray(data)

    def set_recursive_sequence_lengths(self, lens):
        self._lens = [list(l) for l in lens]

    def recursive_sequence_lengths(self):
        return self._lens

    def lod(self):
        """Offset-based view of the level-0 lengths."""
        out = []
        for level in self._lens:
            offs = [0]
            for l in level:
                offs.append(offs[-1] + l)
            out.append(offs)
        return out

    def __array__(self, dtype=None):
        return self._data.astype(dtype) if dtype else self._data

    @property
    def shape(self):
        return list(self._data.shape)

    def to_padded(self, pad_value=0):
        """(padded [B, T, ...], lengths [B]) under this framework's
        convention; uses the innermost length level."""
        if not self._lens:
            return self._data, None
        lens = self._lens[-1]
        t = max(lens) if lens else 0
        trail = self._data.shape[1:]
        out = np.full((len(lens), t) + trail, pad_value,
                      self._data.dtype)
        off = 0
        for i, l in enumerate(lens):
            out[i, :l] = self._data[off:off + l]
            off += l
        return out, np.asarray(lens, np.int32)

    def to_nested_padded(self, pad_value=0):
        """The lod_level=2 dense encoding (framework/lod_tensor.h:58
        nested LoD -> this framework's convention): a 2-level tensor
        (B outer items -> inner sequences -> rows) becomes

            (padded [B, S, W, ...], outer_lens [B], inner_lens [B, S])

        where S = max inner-sequence count, W = max inner length.
        outer_lens[b] = #inner sequences of item b; inner_lens[b, s] =
        length of item b's s-th inner sequence (0 past outer_lens[b]).
        This is the feed/return contract every lod_level=2 workload
        (paragraph->sentence pooling, beam-decode output) uses."""
        if len(self._lens) != 2:
            raise ValueError(
                f"to_nested_padded needs exactly 2 LoD levels, have "
                f"{len(self._lens)}")
        outer, inner = self._lens
        if sum(outer) != len(inner):
            raise ValueError(
                f"LoD levels inconsistent: outer sums to {sum(outer)} "
                f"inner sequences but level 2 lists {len(inner)}")
        if sum(inner) != self._data.shape[0]:
            raise ValueError(
                f"LoD inconsistent with data: inner lengths sum to "
                f"{sum(inner)} rows but data has "
                f"{self._data.shape[0]}")
        b = len(outer)
        s = max(outer) if outer else 0
        w = max(inner) if inner else 0
        trail = self._data.shape[1:]
        out = np.full((b, s, w) + trail, pad_value, self._data.dtype)
        outer_lens = np.asarray(outer, np.int32)
        inner_lens = np.zeros((b, s), np.int32)
        seq = 0
        off = 0
        for i, n_seq in enumerate(outer):
            for j in range(n_seq):
                l = inner[seq]
                inner_lens[i, j] = l
                out[i, j, :l] = self._data[off:off + l]
                off += l
                seq += 1
        return out, outer_lens, inner_lens

    @classmethod
    def from_nested_padded(cls, padded, outer_lens, inner_lens):
        """Inverse of :meth:`to_nested_padded`: rebuild the flat-data +
        2-level recursive_seq_lens LoDTensor from the dense encoding."""
        padded = np.asarray(padded)
        outer_lens = np.asarray(outer_lens)
        inner_lens = np.asarray(inner_lens)
        rows = []
        outer, inner = [], []
        for i, n_seq in enumerate(outer_lens):
            outer.append(int(n_seq))
            for j in range(int(n_seq)):
                l = int(inner_lens[i, j])
                inner.append(l)
                rows.append(padded[i, j, :l])
        flat = (np.concatenate(rows, axis=0) if rows
                else padded.reshape((0,) + padded.shape[3:]))
        return cls(flat, [outer, inner])


Tensor = LoDTensor


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """lod_tensor.py create_lod_tensor: a list of ragged rows, a flat
    ndarray + lens, or another LoDTensor."""
    if isinstance(data, LoDTensor):
        return LoDTensor(np.asarray(data), data.recursive_sequence_lengths())
    if isinstance(data, list):
        flat = np.concatenate([np.asarray(r).reshape(len(r), -1)
                               for r in data], axis=0)
        inferred = [[len(r) for r in data]]
        if recursive_seq_lens:
            inferred = recursive_seq_lens
        return LoDTensor(flat, inferred)
    return LoDTensor(np.asarray(data), recursive_seq_lens)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place,
                                low, high):
    """lod_tensor.py create_random_int_lodtensor."""
    total = sum(recursive_seq_lens[-1])
    data = np.random.randint(low, high + 1,
                             size=[total] + list(base_shape)).astype(
                                 np.int64)
    return LoDTensor(data, recursive_seq_lens)

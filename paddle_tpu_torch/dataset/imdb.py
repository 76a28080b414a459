"""IMDB sentiment (counterpart of
``paddle_tpu/dataset/imdb.py``, after the reference's python/paddle/dataset/imdb.py).

Schema: (word_ids list[int], label 0/1) with `word_dict()` returning a
vocab map. Synthetic: two vocab regions with class-skewed sampling so a
bag-of-words model separates the classes (keeps understand-the-signal
book tests meaningful).
"""

from __future__ import annotations

import numpy as np

VOCAB_SIZE = 5147  # close to the reference's ~5149 cutoff vocab


def word_dict():
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 120))
            # positive reviews skew to low ids, negative to high
            center = VOCAB_SIZE // 4 if label else 3 * VOCAB_SIZE // 4
            ids = np.clip(
                rng.normal(center, VOCAB_SIZE / 6, length),
                0, VOCAB_SIZE - 1).astype(np.int64)
            yield ids.tolist(), label
    return reader


def train(word_idx=None):
    return _reader(2000, 31)


def test(word_idx=None):
    return _reader(400, 32)


def tokenize(tar_path, pattern):
    """Tokenize the REAL aclImdb tarball (the reference's
    dataset/imdb.py:25): sequentially walk members whose names match
    ``pattern`` (a compiled regex), strip trailing newlines, delete
    punctuation, lowercase, split."""
    import string
    import tarfile

    table = bytes.maketrans(b"", b"")
    punct = string.punctuation.encode()
    with tarfile.open(tar_path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if pattern.match(tf.name):
                yield tarf.extractfile(tf).read().rstrip(
                    b"\n\r").translate(table, punct).lower().split()
            tf = tarf.next()


def build_dict(tar_path, pattern, cutoff):
    """Frequency-cutoff vocab over the tokenized corpus
    (dataset/imdb.py:45 build_dict): words with freq > cutoff, ids by
    (-freq, word) order, plus a trailing ``<unk>``."""
    import collections

    word_freq = collections.defaultdict(int)
    for doc in tokenize(tar_path, pattern):
        for word in doc:
            word_freq[word] += 1
    kept = [x for x in word_freq.items() if x[1] > cutoff]
    dictionary = sorted(kept, key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(dictionary)}
    word_idx[b"<unk>"] = len(word_idx)
    return word_idx


def reader_creator(tar_path, pos_pattern, neg_pattern, word_idx):
    """(dataset/imdb.py:65) — id-sequences + labels from the real
    tarball; pos label 0, neg label 1 (the reference's polarity)."""
    unk = word_idx[b"<unk>"]
    ins = []
    for pattern, label in ((pos_pattern, 0), (neg_pattern, 1)):
        for doc in tokenize(tar_path, pattern):
            ins.append(([word_idx.get(w, unk) for w in doc], label))

    def reader():
        yield from ins

    return reader

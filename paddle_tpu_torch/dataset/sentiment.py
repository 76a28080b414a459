"""NLTK movie-reviews sentiment dataset (counterpart of
``paddle_tpu/dataset/sentiment.py``, after the reference's
python/paddle/dataset/sentiment.py).

Schema: (word_id_list, label) — label 0=neg 1=pos; word ids are ranks
in the corpus-wide frequency table (most frequent = 0); samples
interleave neg/pos (reference sentiment.py:77-106 sort_files /
load_sentiment_data), first 1600 = train, rest = test.

The REAL corpus layout is nltk's ``corpora/movie_reviews/{neg,pos}/
*.txt`` (whitespace-tokenized review text) under DATA_HOME; when it is
absent (nothing is downloaded) a deterministic synthetic corpus with the
same layout semantics is generated in memory.
"""

from __future__ import annotations

import collections
import os
from itertools import chain

from .common import DATA_HOME

__all__ = ["train", "test", "get_word_dict", "convert"]

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000


def _corpus_dir():
    d = os.path.join(DATA_HOME, "corpora", "movie_reviews")
    if os.path.isdir(os.path.join(d, "neg")) and os.path.isdir(
            os.path.join(d, "pos")):
        return d
    return None


def _read_real(d):
    """{category: [(fileid, [words...]), ...]} from the nltk layout."""
    out = {}
    for cat in ("neg", "pos"):
        files = sorted(os.listdir(os.path.join(d, cat)))
        samples = []
        for fn in files:
            with open(os.path.join(d, cat, fn), "r",
                      errors="replace") as f:
                # nltk-style fileid: category-prefixed ("neg/cv000.txt")
                samples.append((f"{cat}/{fn}", f.read().split()))
        out[cat] = samples
    return out


def _read_synthetic():
    """Deterministic stand-in corpus with a zipf-ish vocabulary and
    class-correlated marker words."""
    import numpy as np

    rng = np.random.RandomState(77)
    vocab = [f"word{i}" for i in range(200)]
    out = {}
    for ci, cat in enumerate(("neg", "pos")):
        samples = []
        for i in range(NUM_TOTAL_INSTANCES // 2):
            length = int(rng.randint(20, 60))
            # zipf-ish draw + class marker tokens
            idx = (rng.zipf(1.3, length) - 1) % len(vocab)
            words = [vocab[j] for j in idx]
            words += ["awful", "bad"] if cat == "neg" else ["great",
                                                            "fine"]
            samples.append((f"{cat}/cv{i:03d}.txt", words))
        out[cat] = samples
    return out


def _load_corpus():
    d = _corpus_dir()
    return _read_real(d) if d else _read_synthetic()


def get_word_dict():
    """[(word, rank)] sorted by descending corpus frequency (reference
    sentiment.py:56-74)."""
    corpus = _load_corpus()
    freq = collections.defaultdict(int)
    for cat in corpus:
        for _, words in corpus[cat]:
            for w in words:
                freq[w] += 1
    ranked = sorted(freq.items(), key=lambda kv: -kv[1])
    return [(w, i) for i, (w, _) in enumerate(ranked)]


def sort_files():
    """Interleave neg/pos file ids (reference sentiment.py:77-88)."""
    corpus = _load_corpus()
    neg = [fid for fid, _ in corpus["neg"]]
    pos = [fid for fid, _ in corpus["pos"]]
    return list(chain.from_iterable(zip(neg, pos)))


def load_sentiment_data():
    corpus = _load_corpus()
    by_id = {fid: (words, 0 if "neg" in fid else 1)
             for cat in corpus for fid, words in
             ((f, w) for f, w in corpus[cat])}
    word_ids = dict(get_word_dict())
    data = []
    for fid in sort_files():
        words, label = by_id[fid]
        data.append(([word_ids[w.lower()] if w.lower() in word_ids
                      else word_ids[w] for w in words], label))
    return data


def reader_creator(data):
    for sample in data:
        yield sample[0], sample[1]


def train():
    data = load_sentiment_data()
    return reader_creator(data[0:NUM_TRAINING_INSTANCES])


def test():
    data = load_sentiment_data()
    return reader_creator(data[NUM_TRAINING_INSTANCES:])


def fetch():
    return _corpus_dir()


def convert(path):
    from . import common
    common.convert(path, train, 1000, "sentiment_train")
    common.convert(path, test, 1000, "sentiment_test")

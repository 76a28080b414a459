"""WMT14 FR-EN (counterpart of
``paddle_tpu/dataset/wmt14.py``, after the reference's python/paddle/dataset/wmt14.py).

Schema: (src_ids, trg_ids, trg_next_ids) — source wrapped in
<s>...</e>, target input prefixed with <s>, target next suffixed with
<e>; sequences longer than 80 tokens dropped (reference
wmt14.py:82-113 reader_creator).

`reader_creator` parses the REAL wmt14.tgz layout: a tarball whose
members end in ``src.dict`` / ``trg.dict`` (one token per line, id =
line number) and data files (``train/train``, ``test/test``,
``gen/gen``) of tab-separated parallel sentences. When no tarball is
cached locally (nothing is downloaded), `train`/`test` fall back to the
synthetic deterministic-permutation corpus (same schema).
"""

from __future__ import annotations

import tarfile

import numpy as np

from .common import local_or_none

__all__ = ["train", "test", "gen", "get_dict", "convert"]

URL_TRAIN = "http://paddlemodels.bj.bcebos.com/wmt/wmt14.tgz"
MD5_TRAIN = "0791583d57d5beb693b9414c5b36798c"

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2

_SYN_VOCAB = 1000


def __read_to_dict(tar_file, dict_size):
    """First `dict_size` lines of */src.dict and */trg.dict → id maps
    (reference wmt14.py:56-79)."""
    def to_dict(fd, size):
        out = {}
        for line_count, line in enumerate(fd):
            if line_count >= size:
                break
            out[line.strip().decode("utf-8", "replace")] = line_count
        return out

    with tarfile.open(tar_file, mode="r") as f:
        src_names = [m.name for m in f if m.name.endswith("src.dict")]
        trg_names = [m.name for m in f if m.name.endswith("trg.dict")]
        assert len(src_names) == 1 and len(trg_names) == 1
        src_dict = to_dict(f.extractfile(src_names[0]), dict_size)
        trg_dict = to_dict(f.extractfile(trg_names[0]), dict_size)
        return src_dict, trg_dict


def reader_creator(tar_file, file_name, dict_size):
    def reader():
        src_dict, trg_dict = __read_to_dict(tar_file, dict_size)
        with tarfile.open(tar_file, mode="r") as f:
            names = [m.name for m in f if m.name.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    line = line.decode("utf-8", "replace")
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_words = parts[0].split()
                    src_ids = [src_dict.get(w, UNK_IDX)
                               for w in [START] + src_words + [END]]
                    trg_words = parts[1].split()
                    trg_ids = [trg_dict.get(w, UNK_IDX)
                               for w in trg_words]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    trg_ids_next = trg_ids + [trg_dict[END]]
                    trg_ids = [trg_dict[START]] + trg_ids
                    yield src_ids, trg_ids, trg_ids_next

    return reader


def _synthetic(n, seed, dict_size):
    vocab = min(dict_size, _SYN_VOCAB)
    rng0 = np.random.RandomState(29)
    perm = rng0.permutation(np.arange(3, vocab))

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            length = int(rng.randint(3, 30))
            src_body = rng.randint(3, vocab, length)
            trg_body = perm[src_body - 3]
            src_ids = [0] + src_body.tolist() + [1]
            trg_ids = [0] + trg_body.tolist()
            trg_next = trg_body.tolist() + [1]
            yield src_ids, trg_ids, trg_next

    return reader


def _tar():
    return local_or_none(URL_TRAIN, "wmt14")


def train(dict_size):
    t = _tar()
    if t is not None:
        return reader_creator(t, "train/train", dict_size)
    return _synthetic(2000, 51, dict_size)


def test(dict_size):
    t = _tar()
    if t is not None:
        return reader_creator(t, "test/test", dict_size)
    return _synthetic(200, 52, dict_size)


def gen(dict_size):
    t = _tar()
    if t is not None:
        return reader_creator(t, "gen/gen", dict_size)
    return _synthetic(100, 53, dict_size)


def get_dict(dict_size, reverse=True):
    """Token<->id maps; reverse=True returns id->token (reference
    wmt14.py:156-164)."""
    t = _tar()
    if t is not None:
        src_dict, trg_dict = __read_to_dict(t, dict_size)
    else:
        vocab = min(dict_size, _SYN_VOCAB)
        base = {START: 0, END: 1, UNK: 2}
        base.update({f"w{i}": i for i in range(3, vocab)})
        src_dict = dict(base)
        trg_dict = dict(base)
    if reverse:
        src_dict = {v: k for k, v in src_dict.items()}
        trg_dict = {v: k for k, v in trg_dict.items()}
    return src_dict, trg_dict


def fetch():
    return _tar()


def convert(path):
    from . import common
    dict_size = 30000
    common.convert(path, train(dict_size), 1000, "wmt14_train")
    common.convert(path, test(dict_size), 1000, "wmt14_test")

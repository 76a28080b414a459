"""The port's dataset zoo (``paddle_tpu_torch.dataset``) against the JAX
package's, on the CPU.

- **Records.** Every ``train()``/``test()`` reader of the 15 modules yields
  the JAX reader's records: the first 64 equal field by field
  (``np.array_equal``) and the same count.
- **Real formats.** The parsers read the files tests/test_dataset_last5.py
  writes (its own fixture builders) and give the JAX parsers' records.
- **No network.** ``common.download`` raises where the file is not on
  disk; ``common.convert`` (and the modules' ``convert``) raise naming
  ROADMAP A13, whose RecordIO writer they need.
- **The surface.** The module list and each module's public names equal
  the JAX package's; no module imports PIL at import time.
"""

import io
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest

import paddle_tpu.dataset as jds

import paddle_tpu_torch.dataset as pds

import test_dataset_last5 as last5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST = 64

READERS = {
    "mnist.train": lambda d: d.mnist.train(),
    "mnist.test": lambda d: d.mnist.test(),
    "cifar.train10": lambda d: d.cifar.train10(),
    "cifar.test10": lambda d: d.cifar.test10(),
    "cifar.train100": lambda d: d.cifar.train100(),
    "cifar.test100": lambda d: d.cifar.test100(),
    "uci_housing.train": lambda d: d.uci_housing.train(),
    "uci_housing.test": lambda d: d.uci_housing.test(),
    "imdb.train": lambda d: d.imdb.train(),
    "imdb.test": lambda d: d.imdb.test(),
    "imikolov.train": lambda d: d.imikolov.train(),
    "imikolov.test": lambda d: d.imikolov.test(n=3),
    "movielens.train": lambda d: d.movielens.train(),
    "movielens.test": lambda d: d.movielens.test(),
    "flowers.train": lambda d: d.flowers.train(32, 32),
    "flowers.test": lambda d: d.flowers.test(32, 32),
    "flowers.valid": lambda d: d.flowers.valid(32, 32),
    "wmt14.train": lambda d: d.wmt14.train(30000),
    "wmt14.test": lambda d: d.wmt14.test(30000),
    "wmt14.gen": lambda d: d.wmt14.gen(30000),
    "wmt16.train": lambda d: d.wmt16.train(),
    "wmt16.test": lambda d: d.wmt16.test(),
    "sentiment.train": lambda d: d.sentiment.train,
    "sentiment.test": lambda d: d.sentiment.test,
    "mq2007.train": lambda d: d.mq2007.train,
    "mq2007.test": lambda d: d.mq2007.test,
    "mq2007.train.listwise": lambda d: lambda: d.mq2007.train(
        format="listwise"),
    "voc2012.train": lambda d: d.voc2012.train(),
    "voc2012.test": lambda d: d.voc2012.test(),
    "voc2012.val": lambda d: d.voc2012.val(),
    "conll05.train": lambda d: d.conll05.train(),
    "conll05.test": lambda d: d.conll05.test(),
}


def same(a, b):
    """Field-by-field equality of two records (tuples, lists, arrays,
    scalars), dtype included for arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def assert_same_stream(jreader, preader):
    """The first FIRST records equal, and the same count."""
    n = 0
    jit, pit = iter(jreader()), iter(preader())
    for j in jit:
        p = next(pit)
        if n < FIRST:
            assert same(p, j), f"record {n}: {p!r} != {j!r}"
        n += 1
    assert next(pit, None) is None, f"the port yields more than {n}"
    assert n > 0


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_records_equal_the_jax_readers(name):
    assert_same_stream(READERS[name](jds), READERS[name](pds))


@pytest.mark.parametrize("fn", [
    lambda d: d.imdb.word_dict(), lambda d: d.imikolov.build_dict(),
    lambda d: d.conll05.get_dict(), lambda d: d.wmt14.get_dict(100),
    lambda d: d.wmt16.get_dict("en", 100), lambda d: d.sentiment.get_word_dict(),
    lambda d: (d.movielens.max_user_id(), d.movielens.max_movie_id(),
               d.movielens.max_job_id(), d.movielens.movie_categories(),
               d.movielens.get_movie_title_dict())],
    ids=["imdb", "imikolov", "conll05", "wmt14", "wmt16", "sentiment",
         "movielens"])
def test_dictionaries_equal_the_jax_ones(fn):
    assert fn(pds) == fn(jds)


def test_module_list_and_names_equal_the_jax_packages():
    assert pds.__all__ == jds.__all__
    for m in jds.__all__:
        jmod, pmod = getattr(jds, m), getattr(pds, m)
        jnames = {n for n in dir(jmod) if not n.startswith("_")}
        pnames = {n for n in dir(pmod) if not n.startswith("_")}
        assert pnames == jnames, (m, jnames ^ pnames)


def test_no_module_imports_pil_or_jax():
    code = ("import sys, paddle_tpu_torch.dataset as d; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'jax', 'paddle_tpu')))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_download_raises_and_convert_names_a13(tmp_path, monkeypatch):
    for d in (jds, pds):
        monkeypatch.setattr(d.common, "DATA_HOME", str(tmp_path))
        with pytest.raises(IOError, match="downloads are disabled"):
            d.common.download("http://example.invalid/x.tgz", "mod")
        assert d.common.local_or_none("http://example.invalid/x.tgz",
                                      "mod") is None
    os.makedirs(tmp_path / "mod")
    (tmp_path / "mod" / "x.tgz").write_bytes(b"abc")
    assert pds.common.download("http://h/x.tgz", "mod") == str(
        tmp_path / "mod" / "x.tgz")
    assert pds.common.md5file(str(tmp_path / "mod" / "x.tgz")) == \
        jds.common.md5file(str(tmp_path / "mod" / "x.tgz"))
    for convert in (lambda: pds.common.convert(str(tmp_path), lambda: iter(
            []), 2, "demo"), lambda: pds.sentiment.convert(str(tmp_path)),
            lambda: pds.wmt14.convert(str(tmp_path))):
        with pytest.raises(NotImplementedError, match="A13"):
            convert()


def test_data_home_reads_the_same_variable():
    code = ("import paddle_tpu_torch.dataset.common as c; "
            "print(c.DATA_HOME)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO,
                       env=dict(os.environ, PADDLE_TPU_DATA_HOME="/x/y"))
    assert r.stdout.strip() == "/x/y"


# ---------------------------------------------------------------------------
# the real-format parsers, on tests/test_dataset_last5.py's files
# ---------------------------------------------------------------------------

def test_wmt14_real_tarball(tmp_path):
    tgz = str(tmp_path / "wmt14.tgz")
    last5._make_wmt14_tgz(tgz)
    for sub in ("train/train", "test/test"):
        assert_same_stream(jds.wmt14.reader_creator(tgz, sub, 30000),
                           pds.wmt14.reader_creator(tgz, sub, 30000))


def test_sentiment_real_corpus(tmp_path, monkeypatch):
    root = tmp_path / "corpora" / "movie_reviews"
    for cat, docs in {"neg": ["this movie was awful bad awful",
                              "terrible awful plot bad acting"],
                      "pos": ["a great film truly great",
                              "wonderful great acting fine story"]}.items():
        os.makedirs(root / cat)
        for i, doc in enumerate(docs):
            (root / cat / f"cv{i:03d}.txt").write_text(doc)
    for d in (jds, pds):
        monkeypatch.setattr(d.sentiment, "DATA_HOME", str(tmp_path))
        monkeypatch.setattr(d.sentiment, "NUM_TRAINING_INSTANCES", 2)
    assert pds.sentiment.get_word_dict() == jds.sentiment.get_word_dict()
    assert pds.sentiment.load_sentiment_data() == \
        jds.sentiment.load_sentiment_data()
    assert list(pds.sentiment.train()) == list(jds.sentiment.train())
    assert list(pds.sentiment.test()) == list(jds.sentiment.test())


def _voc_tar(path, module):
    from PIL import Image
    keys = ["2007_000001", "2007_000002"]
    with tarfile.open(path, "w") as tf:
        listing = "\n".join(keys).encode()
        info = tarfile.TarInfo(module.SET_FILE.format("trainval"))
        info.size = len(listing)
        tf.addfile(info, io.BytesIO(listing))
        rng = np.random.RandomState(0)
        for k in keys:
            for fmt, arr, name in (
                    ("JPEG", rng.randint(0, 255, (24, 18, 3)),
                     module.DATA_FILE),
                    ("PNG", rng.randint(0, 21, (24, 18)), module.LABEL_FILE)):
                buf = io.BytesIO()
                Image.fromarray(arr.astype(np.uint8)).save(buf, format=fmt)
                info = tarfile.TarInfo(name.format(k))
                info.size = len(buf.getvalue())
                tf.addfile(info, io.BytesIO(buf.getvalue()))


def test_voc2012_real_tar(tmp_path):
    pytest.importorskip("PIL")
    tar_path = str(tmp_path / "voc.tar")
    _voc_tar(tar_path, jds.voc2012)
    assert (pds.voc2012.SET_FILE, pds.voc2012.DATA_FILE,
            pds.voc2012.LABEL_FILE) == (jds.voc2012.SET_FILE,
                                        jds.voc2012.DATA_FILE,
                                        jds.voc2012.LABEL_FILE)
    assert_same_stream(jds.voc2012.reader_creator(tar_path, "trainval"),
                       pds.voc2012.reader_creator(tar_path, "trainval"))


def test_mq2007_real_letor_format(tmp_path, monkeypatch):
    fold = tmp_path / "MQ2007" / "MQ2007" / "Fold1"
    os.makedirs(fold)
    lines = []
    for qid, labels in [(10, [2, 0, 1]), (11, [0, 0, 0]), (12, [1, 2])]:
        for d, lab in enumerate(labels):
            feats = " ".join(f"{i + 1}:{0.01 * (i + d):.6f}"
                             for i in range(46))
            lines.append(f"{lab} qid:{qid} {feats} #docid = GX{qid}-{d}")
    (fold / "train.txt").write_text("\n".join(lines))
    for d in (jds, pds):
        monkeypatch.setattr(d.mq2007, "DATA_HOME", str(tmp_path))
    path = "MQ2007/Fold1/train.txt"
    jq = jds.mq2007.query_filter(jds.mq2007.load_from_text(path))
    pq = pds.mq2007.query_filter(pds.mq2007.load_from_text(path))
    assert [q.query_id for q in pq] == [q.query_id for q in jq] == [10, 12]
    for gen in ("gen_plain_txt", "gen_point", "gen_pair", "gen_list"):
        for j, p in zip(jq, pq):
            assert_same_stream(lambda: getattr(jds.mq2007, gen)(j),
                               lambda: getattr(pds.mq2007, gen)(p))
    for fmt in ("pairwise", "listwise", "pointwise", "plain_txt"):
        assert_same_stream(lambda: jds.mq2007.train(format=fmt),
                           lambda: pds.mq2007.train(format=fmt))


def test_image_functions(tmp_path):
    pytest.importorskip("PIL")
    raw = last5._png_bytes(40, 30)
    for color in (True, False):
        assert same(pds.image.load_image_bytes(raw, color),
                    jds.image.load_image_bytes(raw, color))
    im = jds.image.load_image_bytes(last5._png_bytes(50, 70, seed=1))
    assert same(pds.image.resize_short(im, 60), jds.image.resize_short(im, 60))
    assert same(pds.image.center_crop(im, 24), jds.image.center_crop(im, 24))
    assert same(pds.image.left_right_flip(im), jds.image.left_right_flip(im))
    assert same(pds.image.to_chw(im), jds.image.to_chw(im))
    for kw in ({}, {"mean": [1.0, 2.0, 3.0]}):
        assert same(pds.image.simple_transform(im, 32, 24, False, **kw),
                    jds.image.simple_transform(im, 32, 24, False, **kw))
    p = str(tmp_path / "a.png")
    with open(p, "wb") as f:
        f.write(raw)
    assert same(pds.image.load_and_transform(p, 32, 24, False),
                jds.image.load_and_transform(p, 32, 24, False))


def test_image_batch_images_from_tar(tmp_path):
    pytest.importorskip("PIL")
    import pickle
    out = {}
    for tag, d in (("jax", jds), ("port", pds)):
        tar_path = str(tmp_path / f"{tag}.tar")
        img2label = {}
        with tarfile.open(tar_path, "w") as tf:
            for i in range(5):
                payload = last5._png_bytes(8, 8, seed=i)
                name = f"train/img_{i}.png"
                info = tarfile.TarInfo(name)
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
                img2label[name] = i % 2
        meta = d.image.batch_images_from_tar(tar_path, "train", img2label,
                                             num_per_batch=2)
        batches = []
        for bf in (line.strip() for line in open(meta)):
            with open(bf, "rb") as f:
                batches.append(pickle.load(f))
        out[tag] = batches
    assert len(out["port"]) == len(out["jax"]) == 3
    for a, b in zip(out["port"], out["jax"]):
        assert a["label"] == b["label"] and a["data"] == b["data"]

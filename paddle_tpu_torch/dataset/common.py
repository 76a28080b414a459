"""Shared dataset plumbing (counterpart of
``paddle_tpu/dataset/common.py``, after the reference's python/paddle/dataset/common.py).

`DATA_HOME` mirrors the reference's cache dir contract; `download()` is
present for API parity but raises unless the file is already there: the
port downloads nothing.
"""

from __future__ import annotations

import hashlib
import os

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module_name: str, md5sum: str = None) -> str:
    """Returns the local path if the file is already cached, else raises:
    nothing is fetched, and callers fall back to synthetic data."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(dirname, url.split("/")[-1])
    if os.path.exists(filename):
        return filename
    raise IOError(
        f"{filename} not present and downloads are disabled: the port "
        "fetches nothing; synthetic data is used instead")


def local_or_none(url: str, module_name: str):
    try:
        return download(url, module_name)
    except IOError:
        return None


def convert(output_path, reader, line_count, name_prefix):
    """Serialize a reader to a recordio file (reference common.py:190
    convert). It needs the RecordIO writer, which the port has not taken
    yet: it raises, naming ROADMAP A13."""
    raise NotImplementedError(
        "dataset.common.convert needs the RecordIO writer (native/), "
        "which waits for ROADMAP A13")

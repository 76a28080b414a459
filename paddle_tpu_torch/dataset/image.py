"""Image preprocessing utilities (counterpart of
``paddle_tpu/dataset/image.py``, after the reference's python/paddle/dataset/image.py).

The reference builds these on opencv; this build decodes with Pillow
(imported inside the functions that need it) and resizes with PIL's bicubic — same HWC
uint8 contract in and float32 CHW contract out of `simple_transform`.
Grayscale loads yield HW arrays, color loads HWC-RGB (the reference's
cv2 gives BGR — callers that train from scratch see a consistent
channel order either way; document the delta rather than emulate BGR).
"""

from __future__ import annotations

import io
import os
import pickle
import tarfile

import numpy as np

__all__ = [
    "load_image_bytes", "load_image", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar",
]


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pack raw image bytes + labels from a tar into pickled batch
    files and write a meta list (reference image.py:80-138). Returns
    the meta file path."""
    batch_dir = data_file + "_batch"
    out_path = "%s/%s" % (batch_dir, dataset_name)
    meta_file = "%s/%s.txt" % (batch_dir, dataset_name)
    if os.path.exists(out_path):
        return meta_file
    os.makedirs(out_path)

    tf = tarfile.open(data_file)
    data, labels, file_id = [], [], 0

    def flush():
        nonlocal file_id, data, labels
        with open("%s/batch_%d" % (out_path, file_id), "wb") as f:
            pickle.dump({"label": labels, "data": data}, f, protocol=2)
        file_id += 1
        data, labels = [], []

    for mem in tf.getmembers():
        if mem.name in img2label:
            data.append(tf.extractfile(mem).read())
            labels.append(img2label[mem.name])
            if len(data) == num_per_batch:
                flush()
    if data:
        flush()
    with open(meta_file, "a") as meta:
        for fn in os.listdir(out_path):
            meta.write(os.path.abspath("%s/%s" % (out_path, fn)) + "\n")
    return meta_file


def load_image_bytes(bytes, is_color=True):  # noqa: A002 — ref name
    """Decode an in-memory encoded image to HWC uint8 (HW if gray)."""
    from PIL import Image

    img = Image.open(io.BytesIO(bytes))
    img = img.convert("RGB" if is_color else "L")
    return np.array(img)


def load_image(file, is_color=True):  # noqa: A002 — ref name
    with open(file, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def resize_short(im, size):
    """Resize so the SHORTER edge equals `size` (aspect preserved),
    bicubic (reference image.py:197-222)."""
    from PIL import Image

    h, w = im.shape[:2]
    h_new, w_new = size, size
    if h > w:
        h_new = size * h // w
    else:
        w_new = size * w // h
    img = Image.fromarray(im)
    img = img.resize((int(w_new), int(h_new)), Image.BICUBIC)
    return np.array(img)


def to_chw(im, order=(2, 0, 1)):
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    h_end, w_end = h_start + size, w_start + size
    if is_color:
        return im[h_start:h_end, w_start:w_end, :]
    return im[h_start:h_end, w_start:w_end]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h_start = np.random.randint(0, h - size + 1)
    w_start = np.random.randint(0, w - size + 1)
    h_end, w_end = h_start + size, w_start + size
    if is_color:
        return im[h_start:h_end, w_start:w_end, :]
    return im[h_start:h_end, w_start:w_end]


def left_right_flip(im, is_color=True):
    if len(im.shape) == 3 and is_color:
        return im[:, ::-1, :]
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train,
                     is_color=True, mean=None):
    """resize_short -> (random crop + coin-flip LR flip | center crop)
    -> CHW float32 -> optional mean subtraction (reference
    image.py:327-380)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if len(im.shape) == 3:
        im = to_chw(im)

    im = im.astype("float32")
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and is_color:
            mean = mean[:, np.newaxis, np.newaxis]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    im = load_image(filename, is_color)
    return simple_transform(im, resize_size, crop_size, is_train,
                            is_color, mean)

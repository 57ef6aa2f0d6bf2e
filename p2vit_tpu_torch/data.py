"""ImageNet-style data pipeline (counterpart of ``p2vit_tpu/data.py``):
ImageFolder, per-family preprocessing and the batch iterator.

The transform follows torchvision's semantics on PIL and numpy, bit for bit
the JAX package's (preprocessing parity is an accuracy risk):

  resize(shorter side = int(img_size / crop_pct), bicubic)
  → center-crop(img_size) → scale to [0,1] → normalize(mean, std)

Batches are numpy arrays, float32 (B, 3, H, W) images and int64 targets, or
uint8 images under a raw transform; the caller moves them to the device.
PIL is imported when an image is opened, not when this module is.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp")


def _bicubic():
    from PIL import Image

    return Image.BICUBIC


def build_transform(img_size=224, mean=(0.485, 0.456, 0.406),
                    std=(0.229, 0.224, 0.225), crop_pct=0.875,
                    interpolation=None, raw=False):
    """Returns PIL.Image -> float32 CHW ndarray. ``interpolation``: a PIL
    resampling filter, bicubic when None.

    ``raw=True``: stop after resize+crop and return uint8 CHW, the input of
    the device-side uint8 ingest (``serving.attach_u8_ingest``), which
    replays the /255 and the normalize on the device bit for bit."""
    size = int(img_size / crop_pct)
    mean = np.asarray(mean, dtype=np.float32).reshape(3, 1, 1)
    std = np.asarray(std, dtype=np.float32).reshape(3, 1, 1)

    def tf(img):
        img = img.convert("RGB")
        w, h = img.size
        # torchvision Resize(int): shorter side -> size, keep aspect
        if w < h:
            nw, nh = size, max(int(round(size * h / w)), size)
        else:
            nh, nw = size, max(int(round(size * w / h)), size)
        img = img.resize((nw, nh), _bicubic() if interpolation is None else interpolation)
        left = (nw - img_size) // 2
        top = (nh - img_size) // 2
        img = img.crop((left, top, left + img_size, top + img_size))
        if raw:
            return np.asarray(img, dtype=np.uint8).transpose(2, 0, 1)
        arr = np.asarray(img, dtype=np.float32).transpose(2, 0, 1) / 255.0
        return (arr - mean) / std

    return tf


class ImageFolder:
    """Directory-per-class dataset (torchvision.datasets.ImageFolder layout):
    classes are the sorted subdirectory names, targets their indices, samples
    sorted by file name within a class."""

    def __init__(self, root: str, transform=None):
        self.root = root
        self.transform = transform
        self.classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image

        path, target = self.samples[i]
        if not self.transform:
            return Image.open(path), target
        with Image.open(path) as img:
            return self.transform(img), target


class NativeImageFolder(ImageFolder):
    """ImageFolder whose batches decode in the native C++ thread pool
    (``p2vit_tpu_torch/native``): the same libjpeg ISLOW decode, Pillow's
    fixed-point bicubic resampling, center crop and float32 normalize as the
    PIL path, bit for bit. Images the native decoder cannot read (webp,
    bmp, ...) take the PIL path one by one."""

    def __init__(self, root: str, img_size=224, mean=(0.485, 0.456, 0.406),
                 std=(0.229, 0.224, 0.225), crop_pct=0.875, n_threads=0,
                 raw=False):
        # raw=True: uint8 CHW batches (decode, resize, crop; no normalize)
        # for the device-side uint8 ingest
        super().__init__(root, transform=build_transform(img_size, mean, std, crop_pct, raw=raw))
        self.img_size = img_size
        self.resize_size = int(img_size / crop_pct)
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)
        self.n_threads = n_threads
        self.raw = raw

    def load_batch(self, indices):
        import ctypes

        from . import native

        lib = native.load()
        paths = [self.samples[int(i)][0] for i in indices]
        targets = np.asarray([self.samples[int(i)][1] for i in indices], dtype=np.int64)
        n = len(paths)
        rc = np.zeros(n, dtype=np.int32)
        carr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        if self.raw:
            out = np.empty((n, 3, self.img_size, self.img_size), dtype=np.uint8)
            failed = lib.p2vit_load_batch_u8(
                carr, n, self.resize_size, self.img_size,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                self.n_threads,
            )
        else:
            out = np.empty((n, 3, self.img_size, self.img_size), dtype=np.float32)
            mean_c = (ctypes.c_float * 3)(*self.mean)
            std_c = (ctypes.c_float * 3)(*self.std)
            failed = lib.p2vit_load_batch(
                carr, n, self.resize_size, self.img_size, mean_c, std_c,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                self.n_threads,
            )
        if failed:
            for i in np.nonzero(rc)[0]:  # PIL path for each image the decoder refused
                out[i] = self[int(indices[int(i)])][0]
        return out, targets


def iterate_batches(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    prefetch: int = 0,
) -> Iterator[tuple]:
    """Yields (images [B,3,H,W], int64 targets [B]) numpy batches in the
    dataset's order, or a ``np.random.RandomState(seed)`` shuffle of it.
    Datasets with ``load_batch`` (NativeImageFolder) decode a batch at a
    time; others image by image.

    ``prefetch`` > 0: a background thread produces the batches into a queue
    of that depth, so the host decode overlaps the consumer's device step.
    Closing the generator early (a ``break``) stops and joins the thread.
    """
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    native = hasattr(dataset, "load_batch")

    def produce():
        for start in range(0, len(idx), batch_size):
            sel = idx[start : start + batch_size]
            if drop_last and len(sel) < batch_size:
                return
            if native:
                yield dataset.load_batch(sel)
            else:
                imgs, targets = zip(*(dataset[i] for i in sel))
                yield np.stack(imgs), np.asarray(targets, dtype=np.int64)

    if prefetch <= 0:
        yield from produce()
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in produce():
                if not put(item):
                    return
            put(end)
        except Exception as e:  # raised again in the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join()

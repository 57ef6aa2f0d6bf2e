"""The port's data pipeline (``p2vit_tpu_torch/data.py``, ``native/``)
against the JAX package's on the same image files, bit for bit.

* ``build_transform`` for each family's preprocessing, float32 and raw
  uint8, on odd sizes, portrait and landscape, grey, RGBA and palette PNGs
  and JPEGs written with PIL from a seeded numpy draw;
* ``ImageFolder``'s classes and samples, and ``iterate_batches`` with
  shuffle/seed/drop_last and with the prefetch thread;
* the port's native loader (its own copy of ``dataload.cpp``) against the
  JAX package's ``NativeImageFolder`` and against the PIL path, float and
  uint8. These cases skip, as ``tests/test_native_loader.py`` does, when
  either native library does not build here (no libjpeg or libpng).
"""

import dataclasses
import threading

import numpy as np
import pytest
from PIL import Image

from p2vit_tpu import data as jdata
from p2vit_tpu import native as jnative
from p2vit_tpu.models import MODEL_ZOO as J_ZOO
from p2vit_tpu.models import PREPROCESS as J_PREPROCESS
from p2vit_tpu_torch import data as tdata
from p2vit_tpu_torch import native as tnative
from p2vit_tpu_torch.models import MODEL_ZOO, PREPROCESS

FAMILY_SIZE = {"deit": 32, "vit": 40, "swin": 28}  # small img_size per family, crop_pct from PREPROCESS


def _write_images(root, rng, prefix=""):
    """One image of each decode corner; returns {name: path}."""

    def arr(h, w, ch=3):
        return rng.randint(0, 256, (h, w, ch), dtype=np.uint8)

    cases = {}
    for name, (img, ext) in {
        "jpeg_portrait": (Image.fromarray(arr(77, 45)), "jpg"),
        "jpeg_landscape_odd": (Image.fromarray(arr(41, 63)), "jpg"),
        "jpeg_gray": (Image.fromarray(arr(50, 38, 1)[:, :, 0], mode="L"), "jpg"),
        "png_rgb_odd": (Image.fromarray(arr(55, 47)), "png"),
        "png_rgba": (Image.fromarray(np.concatenate([arr(36, 52), arr(36, 52, 1)], axis=-1),
                                     mode="RGBA"), "png"),
        "png_palette": (Image.fromarray(arr(44, 70)).convert("P", palette=Image.ADAPTIVE), "png"),
        "png_gray": (Image.fromarray(arr(60, 33, 1)[:, :, 0], mode="L"), "png"),
    }.items():
        p = str(root / f"{prefix}{name}.{ext}")
        img.save(p, **({"quality": 90} if ext == "jpg" else {}))
        cases[name] = p
    return cases


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return _write_images(tmp_path_factory.mktemp("imgs"), np.random.RandomState(0))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """An ImageFolder of three classes with 3, 4 and 2 images of the decode
    corners (class directories and file names deliberately unsorted on
    disk)."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.RandomState(1)
    for cls, n in (("zebra", 3), ("ant", 4), ("moth", 2)):
        d = root / cls
        d.mkdir()
        for p in list(_write_images(d, rng, prefix="x_").values())[n:]:
            (d / p.split("/")[-1]).unlink()
        (d / "notes.txt").write_text("not an image")
    return str(root)


def test_zoo_and_preprocess_equal_jax():
    """The port's zoo is JAX's and ViT-L at 384, which is JAX's ViT-L at
    img_size 384; the families' preprocessing is JAX's."""
    assert PREPROCESS == J_PREPROCESS
    port_only = {"vit_large_patch16_384": dataclasses.replace(J_ZOO["vit_large_patch16_224"], img_size=384)}
    assert sorted(MODEL_ZOO) == sorted([*J_ZOO, *port_only])
    for k, cfg in MODEL_ZOO.items():
        jc = port_only.get(k) or J_ZOO[k]
        for f in ("img_size", "patch_size", "embed_dim", "num_heads", "num_classes"):
            assert getattr(cfg, f) == getattr(jc, f), (k, f)
    for k, jc in port_only.items():
        assert dataclasses.asdict(MODEL_ZOO[k]) == dataclasses.asdict(jc), k


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("family", ["deit", "vit", "swin"])
def test_build_transform_bitwise(images, family, raw):
    pp = PREPROCESS[family]
    size = FAMILY_SIZE[family]
    t = tdata.build_transform(size, pp["mean"], pp["std"], pp["crop_pct"], raw=raw)
    j = jdata.build_transform(size, pp["mean"], pp["std"], pp["crop_pct"], raw=raw)
    for name, path in images.items():
        with Image.open(path) as a, Image.open(path) as b:
            got, want = t(a), j(b)
        assert got.dtype == want.dtype == (np.uint8 if raw else np.float32), name
        assert got.shape == (3, size, size), name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_build_transform_default_size(images):
    """224 at DeiT's crop (resize to 256): upscaling every small image."""
    t, j = tdata.build_transform(), jdata.build_transform()
    for path in images.values():
        with Image.open(path) as a, Image.open(path) as b:
            np.testing.assert_array_equal(t(a), j(b))


def test_image_folder_equal(folder):
    pp = PREPROCESS["deit"]
    t = tdata.ImageFolder(folder, tdata.build_transform(32, pp["mean"], pp["std"], pp["crop_pct"]))
    j = jdata.ImageFolder(folder, jdata.build_transform(32, pp["mean"], pp["std"], pp["crop_pct"]))
    assert t.classes == j.classes == ["ant", "moth", "zebra"]
    assert t.class_to_idx == j.class_to_idx
    assert t.samples == j.samples and len(t) == 9
    for i in range(len(t)):
        (a, ta), (b, tb) = t[i], j[i]
        assert ta == tb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle,seed,drop_last,prefetch,bs",
                         [(False, 0, False, 0, 4), (True, 3, True, 0, 2), (True, 0, False, 2, 4),
                          (True, 7, True, 2, 4)])
def test_iterate_batches_equal(folder, shuffle, seed, drop_last, prefetch, bs):
    pp = PREPROCESS["swin"]
    t = tdata.ImageFolder(folder, tdata.build_transform(28, pp["mean"], pp["std"], pp["crop_pct"]))
    j = jdata.ImageFolder(folder, jdata.build_transform(28, pp["mean"], pp["std"], pp["crop_pct"]))
    kw = dict(shuffle=shuffle, seed=seed, drop_last=drop_last, prefetch=prefetch)
    got = list(tdata.iterate_batches(t, bs, **kw))
    want = list(jdata.iterate_batches(j, bs, **kw))
    assert len(got) == len(want) == (9 // bs if drop_last else -(-9 // bs))
    for (a, ta), (b, tb) in zip(got, want):
        assert a.dtype == np.float32 and ta.dtype == np.int64
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ta, tb)


def test_prefetch_thread_stops_when_the_consumer_does(folder):
    """A consumer that breaks early (``--limit-val``) leaves no producer
    thread blocked on the full queue, and a decode error reaches it."""
    pp = PREPROCESS["deit"]
    ds = tdata.ImageFolder(folder, tdata.build_transform(32, pp["mean"], pp["std"], pp["crop_pct"]))
    before = threading.active_count()
    it = tdata.iterate_batches(ds, 1, prefetch=1)
    next(it)
    it.close()
    assert threading.active_count() == before

    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise OSError(f"cannot decode {i}")

    with pytest.raises(OSError, match="cannot decode 0"):
        list(tdata.iterate_batches(Broken(), 2, prefetch=2))
    assert threading.active_count() == before


@pytest.fixture(scope="module")
def natives():
    if not (tnative.available() and jnative.available()):
        pytest.skip("native toolchain unavailable (g++ with libjpeg and libpng)")


@pytest.mark.parametrize("raw", [False, True])
def test_native_loader_bitwise(natives, folder, raw):
    """The port's native batches equal the JAX package's native batches and
    the PIL path's (Pillow-exact decode and bicubic resize), float32 and
    uint8, in shuffled batches with a short last batch."""
    pp = PREPROCESS["deit"]
    args = (32, pp["mean"], pp["std"], pp["crop_pct"])
    t = tdata.NativeImageFolder(folder, *args, n_threads=3, raw=raw)
    j = jdata.NativeImageFolder(folder, *args, n_threads=3, raw=raw)
    pil = tdata.ImageFolder(folder, tdata.build_transform(*args, raw=raw))
    kw = dict(shuffle=True, seed=5)
    for (a, ta), (b, tb), (c, tc) in zip(tdata.iterate_batches(t, 4, **kw), jdata.iterate_batches(j, 4, **kw),
                                         tdata.iterate_batches(pil, 4, **kw)):
        assert a.dtype == (np.uint8 if raw else np.float32)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ta, tc)

"""The native data loader (counterpart of ``p2vit_tpu/native``).

``dataload.cpp`` (this package's own copy) decodes JPEG/PNG files, resizes
them with Pillow's exact 8-bit bicubic resampling, crops and normalizes,
over a batch in a C++ thread pool. It is compiled with the system ``g++``,
libjpeg and libpng on first use, into ``build/p2vit_tpu_torch/native/`` at
the checkout's root; the library's file name carries a hash of the source,
so an edited source is rebuilt. ``load()`` returns the ctypes handle or
raises with the compiler's output; ``available()`` says whether it loads.
Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "dataload.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "p2vit_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
LIBS = ("-ljpeg", "-lpng")


def _build() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"_dataload-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")  # one per process: builds may race
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native dataload build needs g++: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native dataload build failed ({' '.join(cmd)}):\n{proc.stderr[-2000:]}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if the source changed) and load the native library."""
    lib = ctypes.CDLL(str(_build()))
    lib.p2vit_load_batch.restype = ctypes.c_int
    lib.p2vit_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.p2vit_load_batch_u8.restype = ctypes.c_int
    lib.p2vit_load_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.p2vit_decode_resize.restype = ctypes.c_int
    lib.p2vit_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def available() -> bool:
    """True when the library builds and loads here (g++, libjpeg, libpng)."""
    try:
        load()
        return True
    except (RuntimeError, OSError):
        return False

"""Build and bind the CUDA kernels in ``p2vit_tpu_torch/csrc``.

All ``.cu`` sources are compiled by ``nvcc`` into ONE shared library with a
plain C interface, on first use, into ``build/p2vit_tpu_torch/`` at the
checkout's root, and loaded with ``ctypes``: one ``nvcc -c`` per source, all
started together, then one link. The library's file name carries a hash of
the sources and flags, so an edited source is rebuilt. Nothing is built or
imported when this module is imported: CPU-only installs never reach
``library()``.

Flags: ``sm_90a`` (Hopper), no fast math, and ``--fmad=false``, because the
plain PyTorch versions round every float32 operation on its own; an FMA
contraction of e.g. ``C·Σx² − (Σx)²`` would flip codes at knife edges.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "p2vit_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "p2v_int8_matmul_requant": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "p2v_int8_matmul_res_ln": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "p2v_lis_attention_qkv_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "p2v_lis_attention_fused": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "p2v_lis_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "p2v_fused_patch_embed": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "p2v_int_ln_requant": [_P, _P, _P, _P, _I, _I, _P],
    "p2v_int_res_ln_requant": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "p2v_swin_lis_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "p2v_swin_lis_attention_folded": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "p2v_fused_swin_stem": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "p2v_fused_vit_layer": [_P] * 15 + [_I] * 6 + [_P],
    "p2v_int4_matmul_requant": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "p2v_wstream_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build(so: Path, cu) -> str:
    """Compile every source in parallel, link them into ``so``; returns the
    compiler output. Waits for every compiler before raising on a failure."""
    nvcc = _nvcc()
    work = so.with_suffix(f".{os.getpid()}.d")
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs = [work / f"{f.stem}.o" for f in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for f, o in zip(cu, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        failed = [f.name for f, p in zip(cu, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = work / so.name
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return log


@functools.cache
def library():
    """Build (if needed) and load the kernel library; returns (lib, build_log)."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    so = BUILD_DIR / f"libp2vit_kernels_{h.hexdigest()[:16]}.so"
    log = ""
    if not so.exists():
        log = _build(so, cu)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.p2v_error_string.argtypes = [ctypes.c_int]
    lib.p2v_error_string.restype = ctypes.c_char_p
    return lib, log


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream; raise on a CUDA error.

    Tensors pass as their data pointers, ``None`` as a null pointer, Python
    ints as C ints. The stream is appended as the last argument.
    """
    lib, _ = library()
    conv = []
    dev = None
    for a in args:
        if isinstance(a, torch.Tensor):
            dev = a.device
            conv.append(ctypes.c_void_p(a.data_ptr()))
        elif a is None:
            conv.append(ctypes.c_void_p(None))
        else:
            conv.append(ctypes.c_int(int(a)))
    conv.append(ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    rc = getattr(lib, name)(*conv)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {lib.p2v_error_string(rc).decode()}")


def device_of(*tensors) -> torch.device:
    """The one device all tensor arguments share; raises on a mismatch."""
    devs = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"arguments lie on different devices: {sorted(map(str, devs))}")
    return devs.pop()


def check_cuda_operand(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``), 16-byte aligned (the kernels load 16-byte chunks)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def f32_vec(v, n: int, device) -> torch.Tensor:
    """Scalar or (n,) value → contiguous float32 (n,) tensor on ``device``."""
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32, device=device), (n,)).contiguous()


def f32_scalars(*vals, device) -> torch.Tensor:
    """Scalars (Python numbers or 0-d tensors) → one float32 vector on
    ``device``, without a host round trip for device tensors."""
    return torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device).reshape(()) for v in vals])

"""The shapes JAX serves that the kernels once refused, each kernel against
its plain version.

    python -m p2vit_tpu_torch.tools.shape_faults [--reps 20]

Six faults (``ROADMAP.md`` queue 3, closed): ``fused_vit_layer`` at C and
hidden widths that are no multiples of 64 (1); N > 256 in
``lis_attention_qkv_fused``, ``lis_attention_fused``, ``lis_attention`` and
``fused_vit_layer`` (2); ``lis_attention_qkv_fused`` at head_dims other
than 64 and C_in % 16 ≠ 0 (3); head_dim 128 in ``lis_attention_fused``,
``lis_attention`` and ``fused_vit_layer`` (4); the Swin attention, panel
and folded, at head_dim 64 and at N = 256 with the shift mask (5);
``fused_swin_stem`` past C = 1024 (6). ``held_cases`` builds every shape
at which each is held, LIS on and off, on seeded codes; the tests
(``tests/test_torch_cuda_shape_faults.py``) and ``chip_smoke.py`` hold each
kernel bit for bit against its plain version there. ``check`` runs the
held shapes for every caller (``chip_smoke.py``'s shape-fault phase and
this tool): per case, the mismatches (0), the wrapper's launches
in one call (1) and the wrapper's µs per call (CUDA events around
calls that the host issues back to back, so mostly host time at these
small shapes), its device µs per call and the kernel's share of them
(``torch.profiler``; the rest is the padding copies), the bound (the larger of the bytes over 3.35 TB/s and
the products over the int8 peak, 1,979 TOP/s; the stem's float32 dot over
67 TFLOP/s) and the card's name and power limit. Needs the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_S, INT8_OPS_S, F32_OPS_S = 3.35e12, 1979e12, 67e12


@dataclasses.dataclass
class Case:
    """One held shape: ``call()`` runs the wrapper, ``plain()`` its plain
    version on the same inputs; ``bytes``/``ops`` the work the bound counts
    (each input read once, each output written once; the integer products,
    or the stem's float32 ones where ``f32``)."""

    name: str
    fault: int
    kernel: str  # the wrapper's name in ``ops.KERNELS``
    call: object
    plain: object
    bytes: int
    ops: int
    f32: bool = False

    @property
    def bound_ms(self) -> float:
        return max(self.bytes / HBM_BYTES_S, self.ops / (F32_OPS_S if self.f32 else INT8_OPS_S)) * 1e3


def _i8(rng, shape, lo=-128, hi=128):
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8))


def _f(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _pot(rng, n, lo, hi):
    return _f(2.0 ** rng.randint(lo, hi, n))


def _ptf(rng, n, base):
    return _f(base * 2.0 ** rng.randint(0, 4, n))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def layer_args(device, b, n, c, heads, hid, seed=21):
    """A seeded encoder layer's 32 arguments at any width (int8 codes, PoT
    requant vectors, PTF residual scales)."""
    rng = np.random.RandomState(seed)
    args = [_i8(rng, (b, n, c)), _i8(rng, (b, n, c)), _i8(rng, (3 * c, c), -8, 8), _pot(rng, 3 * c, -8, -6),
            _f(rng.randn(3 * c)), heads, 2.0**-9, 2.0**-4, 4.0,
            _i8(rng, (c, c), -8, 8), _pot(rng, c, -8, -6), _f(rng.randn(c)), 2.0**-5, _ptf(rng, c, 0.011),
            _ptf(rng, c, 0.03), _f(rng.randn(c)), _f(rng.randn(c) * 0.1), _f(np.abs(rng.randn(c)) * 0.03 + 0.01),
            _pot(rng, c, -1, 2), _i8(rng, (hid, c), -8, 8), _pot(rng, hid, -10, -8), _f(rng.randn(hid) * 0.5), 16.0,
            _i8(rng, (c, hid), -8, 8), _pot(rng, c, -10, -8), _f(rng.randn(c)), 2.0**-4, _ptf(rng, c, 0.04),
            _f(rng.randn(c)), _f(rng.randn(c) * 0.1), _f(np.abs(rng.randn(c)) * 0.03 + 0.01), 1.0]
    return [a.to(device) if isinstance(a, torch.Tensor) else a for a in args]


def _attn_ops(bh, n, d):
    return 4 * bh * n * n * d  # q·kᵀ and attn@v, a multiply and an add each


def _layer_case(device, fault, b, n, c, heads, hid, lis):
    from ..ops import layer_fused

    a = layer_args(device, b, n, c, heads, hid)
    m = b * n
    ops = 2 * m * c * (3 * c + c + 2 * hid) + _attn_ops(b * heads, n, c // heads)
    return Case(f"fused_vit_layer B={b} N={n} C={c} heads={heads} hid={hid} lis={int(lis)}", fault,
                "fused_vit_layer", lambda: layer_fused.fused_vit_layer(*a, lis=lis),
                lambda: layer_fused.fused_vit_layer_plain(*a, lis=lis),
                _nbytes(*a) + 2 * m * c, ops)


def _fused_case(device, fault, b, n, c, heads, lis, seed=3):
    from ..ops import attention_lis as al

    qkv = _i8(np.random.RandomState(seed + n), (b, n, 3 * c)).to(device)
    a = (qkv, heads, 2.0**-11, 2.0**-11 if lis else 2.0**-4, 2.0)
    return Case(f"lis_attention_fused B={b} N={n} C={c} heads={heads} lis={int(lis)}", fault, "lis_attention_fused",
                lambda: al.lis_attention_fused(*a, lis=lis), lambda: al.lis_attention_fused_plain(*a, lis=lis),
                _nbytes(qkv) + b * n * c, _attn_ops(b * heads, n, c // heads))


def _split_case(device, fault, bh, n, d, lis, seed=5):
    from ..ops import attention_lis as al

    rng = np.random.RandomState(seed + n + d)
    q, k, v = (_i8(rng, (bh, n, d)).to(device) for _ in range(3))
    a = (q, k, v, 2.0**-11, 2.0**-4, 2.0)
    return Case(f"lis_attention BH={bh} N={n} d={d} lis={int(lis)}", fault, "lis_attention",
                lambda: al.lis_attention(*a, lis=lis), lambda: al.lis_attention_plain(*a, lis=lis),
                _nbytes(q, k, v) + bh * n * d, _attn_ops(bh, n, d))


def _qkv_case(device, fault, b, n, c, heads, c_in, lis, seed=7):
    from ..ops import attention_lis as al

    rng = np.random.RandomState(seed + n + c_in + heads)
    h, w = _i8(rng, (b, n, c_in)).to(device), _i8(rng, (3 * c, c_in), -8, 8).to(device)
    rv = _pot(rng, 3 * c, -9, -6).to(device)
    bv = _f(rng.randn(3 * c)).to(device)
    a = (h, w, rv, bv, heads, 2.0**-11, 2.0**-11 if lis else 2.0**-4, 0.5)
    return Case(f"lis_attention_qkv_fused B={b} N={n} C={c} heads={heads} C_in={c_in} lis={int(lis)}", fault,
                "lis_attention_qkv_fused", lambda: al.lis_attention_qkv_fused(*a, lis=lis),
                lambda: al.lis_attention_qkv_fused_plain(*a, lis=lis),
                _nbytes(h, w, rv, bv) + b * n * c, 2 * b * n * 3 * c * c_in + _attn_ops(b * heads, n, c // heads))


def swin_inputs(device, b, res, ws, heads, d, seed=11):
    """Seeded raster qkv codes (B, res, res, 3·heads·d), the bias (heads, N,
    N) and the shift mask of a shift of ws/2 divided by s2 = 2^-4."""
    from ..models import swin

    rng = np.random.RandomState(seed + res + d)
    n = ws * ws
    qkv = _i8(rng, (b, res, res, 3 * heads * d)).to(device)
    bias = _f(rng.randn(heads, n, n) * 0.3).to(device)
    mask = torch.from_numpy(swin.shift_attn_mask(res, res, ws, ws // 2) / 2.0**-4).to(device)
    return qkv, bias, mask


def _swin_cases(device, fault, b, res, ws, heads, d, lis):
    from ..models import swin
    from ..ops import attention_lis as al

    qkv, bias, mask = swin_inputs(device, b, res, ws, heads, d)
    n, g = ws * ws, res // ws
    sc = (2.0**-9, 2.0**-4, 2.0**-4, 2.0**-2)
    shift = ws // 2
    panels = swin.window_partition(torch.roll(qkv, (-shift, -shift), (1, 2)), ws).contiguous()
    pa = (panels, bias, mask, heads, g * g, *sc)
    fa = (qkv, bias, mask, heads, ws, *sc)
    nb = _nbytes(qkv, bias, mask) + qkv.numel() // 3
    ops = _attn_ops(b * g * g * heads, n, d)
    tag = f"B={b} res={res} window={ws} N={n} heads={heads} d={d} shift={shift} lis={int(lis)}"
    return [Case(f"swin_lis_attention {tag}", fault, "swin_lis_attention",
                 lambda: al.swin_lis_attention(*pa, lis=lis), lambda: al.swin_lis_attention_plain(*pa, lis=lis),
                 nb, ops),
            Case(f"swin_lis_attention_folded {tag}", fault, "swin_lis_attention_folded",
                 lambda: al.swin_lis_attention_folded(*fa, lis=lis, shift=shift),
                 lambda: al.swin_lis_attention_folded_plain(*fa, lis=lis, shift=shift), nb, ops)]


def stem_args(device, m, k, c, seed=13):
    """Seeded random-normal stem operands (patches, w, bias, s_bn, ln_w,
    ln_b, out_scale)."""
    rng = np.random.RandomState(seed + c)
    return [t.to(device) for t in (_f(rng.randn(m, k)), _f(rng.randn(c, k) * 0.2), _f(rng.randn(c) * 0.05),
                                   torch.tensor(0.04), _f(rng.randn(c)), _f(rng.randn(c) * 0.1),
                                   torch.tensor(0.03))]


def _stem_case(device, fault, m, k, c):
    from ..ops import swin_stem

    a = stem_args(device, m, k, c)
    return Case(f"fused_swin_stem M={m} K={k} C={c}", fault, "fused_swin_stem", lambda: swin_stem.fused_swin_stem(*a),
                lambda: swin_stem.fused_swin_stem_plain(*a), _nbytes(*a) + m * c, 2 * m * c * k, f32=True)


def held_specs() -> list:
    """(id, build) of every held shape of the six faults, LIS on and off where
    the kernel has both arms; ``build(device)`` makes its ``Case`` (or,
    for the Swin shapes, the panel and the folded case). Cheap: nothing is
    built until ``build`` runs."""
    specs = []

    def add(fault, tag, fn, *args):
        specs.append((f"fault{fault}-{tag}", lambda device: fn(device, fault, *args)))

    for lis in (True, False):
        arm = f"lis{int(lis)}"
        # C and hid not multiples of 64: TINY's layer, and C = 96 with hid = 384
        add(1, f"layer-C32-{arm}", _layer_case, 2, 17, 32, 2, 128, lis)
        add(1, f"layer-C96-{arm}", _layer_case, 2, 65, 96, 3, 384, lis)
        # N > 256
        for n in (257, 300, 577):
            add(2, f"qkv-N{n}-{arm}", _qkv_case, 1, n, 384, 6, 384, lis)
            add(2, f"fused-N{n}-{arm}", _fused_case, 2, n, 384, 6, lis)
            add(2, f"split-N{n}-{arm}", _split_case, 4, n, 64, lis)
        for n in (257, 300):
            add(2, f"layer-N{n}-{arm}", _layer_case, 1, n, 384, 6, 1536, lis)
        # the qkv-fused kernel's head_dims and C_in
        add(3, f"qkv-d32-{arm}", _qkv_case, 2, 197, 384, 12, 384, lis)
        add(3, f"qkv-d128-{arm}", _qkv_case, 2, 197, 384, 3, 384, lis)
        add(3, f"qkv-Cin200-{arm}", _qkv_case, 2, 197, 384, 6, 200, lis)
        # head_dim 128
        add(4, f"fused-d128-{arm}", _fused_case, 2, 197, 384, 3, lis)
        add(4, f"split-d128-{arm}", _split_case, 3, 197, 128, lis)
        add(4, f"layer-d128-{arm}", _layer_case, 2, 197, 384, 3, 1536, lis)
        # Swin: head_dim 64 at 7×7 windows, N = 256 (16×16) at head_dim 32
        add(5, f"swin-d64-N49-{arm}", _swin_cases, 2, 14, 7, 2, 64, lis)
        add(5, f"swin-d32-N256-{arm}", _swin_cases, 2, 32, 16, 2, 32, lis)
    for c in (1536, 4096):  # the stem past C = 1024
        add(6, f"stem-C{c}", _stem_case, 3136 + 77, 48, c)
    return specs


def held_cases(device) -> list:
    """Every held shape as ``Case``s on ``device``."""
    out = []
    for _, build in held_specs():
        made = build(device)
        out += made if isinstance(made, list) else [made]
    return out


def mismatches(got, want) -> int:
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
    return sum(int((g != w).sum()) if g.shape == w.shape else max(g.numel(), w.numel()) for g, w in zip(got, want))


# the device kernel each wrapper launches, by a part of its symbol
SYMBOLS = {"fused_vit_layer": "fused_vit_layer_kernel", "lis_attention_fused": "attention_rows_kernel",
           "lis_attention": "attention_rows_kernel", "lis_attention_qkv_fused": "lis_attention_qkv_kernel",
           "swin_lis_attention": "swin_attention_kernel", "swin_lis_attention_folded": "swin_attention_kernel",
           "fused_swin_stem": "swin_stem_kernel"}


def device_us(fn, reps: int, symbol: str, windows: int = 3) -> tuple:
    """(µs of device time per call, of it the kernel ``symbol``'s) over
    ``reps`` calls, from ``torch.profiler``; the rest is the wrapper's
    padding copies. A window in which the profiler saw no device time at all
    (on the H100 machine it loses a whole window's events at times) is taken
    again, up to ``windows`` windows; one with device time but none in
    ``symbol`` stands."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in ev)
        if total > 0:
            break
    kern = sum(e.self_device_time_total for e in ev if symbol in e.key)
    return total / reps, kern / reps


def time_us(fn, reps: int) -> float:
    """Mean µs per call of ``fn`` over ``reps`` calls, by CUDA events after
    one warm call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def check(device, reps: int):
    """Runs every held shape: for each ``Case`` on ``device``, a record of
    its mismatches against the plain version, the wrapper's launches in that
    one call (1), the µs per call by CUDA events and the device µs and the
    kernel's share by ``torch.profiler`` over ``reps`` calls, and the bound;
    ``record["faults"]`` names what failed (a mismatch, a launch count other
    than 1, no device time in the kernel's symbol), empty if nothing did."""
    from ..ops import KERNELS

    counters = {k.__name__: k for k in KERNELS}
    for c in held_cases(device):
        kern = counters[c.kernel]
        before = kern.launches
        got = c.call()
        launched = kern.launches - before
        mis = mismatches(got, c.plain())
        torch.cuda.synchronize()
        dev_us, kern_us = device_us(c.call, reps, SYMBOLS[c.kernel])
        faults = [f"{mis} mismatches"] if mis else []
        if launched != 1:
            faults.append(f"{launched} launches of {c.kernel} in one call")
        if kern_us <= 0:
            faults.append(f"no device time in {SYMBOLS[c.kernel]}")
        yield dict(fault=c.fault, case=c.name, kernel=c.kernel, mismatches=mis, launches=launched,
                   us=time_us(c.call, reps), device_us=dev_us, kernel_us=kern_us, bound_us=c.bound_ms * 1e3,
                   faults=faults)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shape_faults: needs the card", file=sys.stderr)
        return 1
    gpu = card()
    bad = 0
    for rec in check(torch.device("cuda", 0), args.reps):
        bad += bool(rec["faults"])
        print(json.dumps(dict(rec, gpu=gpu)), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

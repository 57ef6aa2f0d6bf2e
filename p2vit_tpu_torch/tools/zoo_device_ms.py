"""Device ms per forward of the zoo serving paths, for one checkout.

    python p2vit_tpu_torch/tools/zoo_device_ms.py [--root DIR]

``--root`` names the checkout whose ``p2vit_tpu_torch`` is imported
(default: the one holding this file), so one run on the card can measure
an older commit unpacked beside this one, in turns with this one (older,
newer, newer, older). DeiT-S (``convert([4]*50)``) and Swin-T
(``convert(4)``) at full width and depth, seeded weights calibrated on 8
seeded images: with LIS on, ``deit`` (the defaults), ``deit_staged``
(``fuse_embed=False, fuse_qkv=False``), ``deit_layer`` (``fuse_layer=True``),
``swin`` (the defaults), ``swin_fold`` (``fold_windows=True``) and
``swin_stem`` (``fuse_stem=True``); with LIS off, as ``chip_smoke.py``
serves them (calibrated on host-normalized uint8 images, served on uint8
images through ``attach_u8_ingest``), ``deit_lisoff`` and
``deit_staged_lisoff``. Per path, at batch 64: the device ms per forward
that ``torch.profiler`` sums over every kernel of 5 forwards, in each of 3
windows after a warm-up, and their median. Needs the card; prints one JSON
line per path with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BATCH, WINDOWS, CALIB = 64, 3, 8
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
STAGED = dict(fuse_embed=False, fuse_qkv=False)
DEIT_FLAGS = {"deit": (True, {}), "deit_staged": (True, STAGED), "deit_layer": (True, dict(fuse_layer=True)),
              "deit_lisoff": (False, {}), "deit_staged_lisoff": (False, STAGED)}
SWIN_FLAGS = {"swin": {}, "swin_fold": dict(fold_windows=True), "swin_stem": dict(fuse_stem=True)}


def device_ms(fn, windows: int, per_window: int = 5) -> list:
    """Device ms per call of ``fn`` in each profiler window (every kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(per_window):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        out.append(sum(e.self_device_time_total for e in ev) / per_window / 1e3)
    return out


def host_normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 images → (u/255 − mean)/std in float32 on the host, then back
    to the images' device (``chip_smoke.py``'s LIS-off calibration input)."""
    mean = np.asarray(MEAN, np.float32).reshape(3, 1, 1)
    std = np.asarray(STD, np.float32).reshape(3, 1, 1)
    return torch.from_numpy((u8.cpu().numpy().astype(np.float32) / np.float32(255.0) - mean) / std).to(u8.device)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose p2vit_tpu_torch is imported")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("zoo_device_ms: needs a CUDA device")
    sys.path.insert(0, args.root)
    from p2vit_tpu_torch import serving, serving_swin
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import SWIN_ZOO, VIT_ZOO, swin, vit

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)

    def u8(b):
        return torch.randint(0, 256, (b, 3, 224, 224), generator=gen, dtype=torch.uint8).to(dev)

    runs = {}
    cfg = VIT_ZOO["deit_small_patch16_224"]
    params = vit.init_params(0, cfg, device=dev)
    for lis in (True, False):
        policy = make_policy(lis=lis)
        calib_x = torch.randn((CALIB, 3, 224, 224), generator=gen).to(dev) if lis else host_normalize(u8(CALIB))
        calib = vit.calibrate(params, cfg, policy, calib_x)
        s = serving.convert(params, calib.qstate, cfg, policy, [4] * cfg.num_matmuls)
        if not lis:
            serving.attach_u8_ingest(s, MEAN, STD)
        x = torch.randn((BATCH, 3, 224, 224), generator=gen).to(dev) if lis else u8(BATCH)
        for p, (p_lis, fl) in DEIT_FLAGS.items():
            if p_lis == lis:
                runs[p] = lambda s=s, x=x, lis=lis, fl=fl: serving.serving_forward(s, cfg, x, lis=lis, **fl)
    policy = make_policy()
    cfg_s = SWIN_ZOO["swin_tiny_patch4_window7_224"]
    sp = swin.init_params(0, cfg_s, device=dev)
    sq = swin.calibrate(sp, cfg_s, policy, torch.randn((CALIB, 3, 224, 224), generator=gen).to(dev)).qstate
    ss = serving_swin.convert(sp, sq, cfg_s, policy, 4)
    xs = torch.randn((BATCH, 3, 224, 224), generator=gen).to(dev)
    for p, fl in SWIN_FLAGS.items():
        runs[p] = lambda fl=fl: serving_swin.serving_forward(ss, sq, cfg_s, policy, xs, **fl)
    lines = []
    for p, fn in runs.items():
        ms = device_ms(fn, WINDOWS)
        line = {"root": args.root, "path": p, "batch": BATCH, "device_ms": [round(m, 4) for m in ms],
                "median_ms": round(statistics.median(ms), 4), "card": card}
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()

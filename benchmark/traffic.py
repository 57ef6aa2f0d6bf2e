"""One general generator of request schedules, driven by a mix's data file
(``traffic/<mix>.json``).

``closed``: full batches of ``batch`` images dispatched ahead, at most
``in_flight`` batches outstanding; the schedule is the ring order alone.
``open``: single-image requests arriving at ``rate_per_s`` (a number, or a
table by configuration name). The gaps between arrivals are the
exponential distribution's quantiles at (k + ½)/K, K = round(rate · seconds),
in an order drawn from the seed: Poisson arrivals in which every seed sends
the same requests and the same gaps, in another order.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MIX_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str, mix_dir: Path = MIX_DIR) -> dict:
    mix = json.loads((mix_dir / f"{name}.json").read_text())
    if mix["loop"] not in ("closed", "open"):
        raise ValueError(f"traffic {name}: loop {mix['loop']!r} is neither closed nor open")
    return mix


def rate(mix: dict, config: str) -> float:
    r = mix["rate_per_s"]
    return float(r[config] if isinstance(r, dict) else r)


def arrivals(mix: dict, config: str, seed: int, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of an open mix's requests."""
    lam = rate(mix, config)
    k = max(1, int(round(lam * seconds)))
    gaps = -np.log1p(-(np.arange(k) + 0.5) / k) / lam
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    return np.cumsum(rng.permutation(gaps))

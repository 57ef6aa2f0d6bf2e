"""The open loop's schedule: the same for one seed, another order for
another seed, the same set of gaps for every seed."""

import numpy as np

from benchmark import traffic
from conftest import SEED


def test_schedule_by_seed():
    mix = traffic.load("online")
    a = traffic.arrivals(mix, "deit_b", SEED, 10.0)
    assert np.array_equal(a, traffic.arrivals(mix, "deit_b", SEED, 10.0))
    b = traffic.arrivals(mix, "deit_b", SEED + 1, 10.0)
    assert not np.array_equal(a, b)
    assert len(a) == len(b) == round(traffic.rate(mix, "deit_b") * 10.0)
    assert np.allclose(np.sort(np.diff(a, prepend=0.0)), np.sort(np.diff(b, prepend=0.0)))
    assert abs(a[-1] - 10.0) < 0.1  # the gaps fill the window


def test_rate_per_config_or_number():
    mix = {"loop": "open", "rate_per_s": {"deit_b": 100.0}}
    assert traffic.rate(mix, "deit_b") == 100.0
    assert traffic.rate({"loop": "open", "rate_per_s": 7}, "any") == 7.0

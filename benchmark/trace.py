"""The traced window: the card's operations read back from
``torch.profiler``'s Chrome trace, beside the harness's host spans, on the
trace's clock."""

from __future__ import annotations

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A kernel's symbol without ``void`` and its argument list."""
    s = name.replace("(anonymous namespace)", "{anon}")
    s = s.split("(")[0].strip()
    return s[5:] if s.startswith("void ") else s


class Trace:
    """Device operations (name, start, end, category) from the profiler's
    events, the harness's host spans (name, start, end) and the window
    (start, end), in seconds on the trace's clock."""

    def __init__(self, events: list, window: tuple, spans: list):
        ops = []
        for e in events:
            if e.get("ph") == "X" and "dur" in e and e.get("cat", "") in DEVICE_CATS:
                t0 = float(e["ts"]) * 1e-6
                ops.append((e["name"], t0, t0 + float(e["dur"]) * 1e-6, e["cat"]))
        self.window = window
        self.ops = sorted(ops, key=lambda o: o[1])
        self.spans = spans

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def clipped(self, cats=DEVICE_CATS):
        """(name, start, end) of device operations, clipped to the window."""
        w0, w1 = self.window
        return [(n, max(a, w0), min(b, w1)) for n, a, b, c in self.ops if c in cats and b > w0 and a < w1]

    def kernels(self, match=None):
        """Kernels inside the window whose symbol contains ``match``."""
        return [k for k in self.clipped(("kernel",)) if match is None or match in k[0]]

    def busy(self):
        """The union of device operations' intervals inside the window."""
        merged = []
        for _, a, b in sorted(self.clipped(), key=lambda o: o[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self):
        """Intervals of the window with no device operation running."""
        w0, w1 = self.window
        out, t = [], w0
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if w1 > t:
            out.append((t, w1))
        return out

    def host_label(self, t: float) -> str:
        """The innermost harness span that holds host time ``t``."""
        inside = [s for s in self.spans if s[1] <= t <= s[2] and s[0].startswith("bench.")]
        return min(inside, key=lambda s: s[2] - s[1])[0] if inside else "host.other"

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing (the span at the gap's middle)."""
        by_name: dict = {}
        for name, a, b in self.clipped():
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.host_label((a + b) / 2), b - a] for a, b in gaps]}

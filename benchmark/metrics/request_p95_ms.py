"""95th percentile over every request due in the window, from its due time
to its logits on the host (host clock; open-loop cells)."""

from benchmark.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 95)

"""Share (%) of the traced window in which no operation (kernel, copy,
memset) ran on the card: one minus the union of their intervals."""

from benchmark.readers import idle_share


def read(ctx):
    return idle_share(ctx)

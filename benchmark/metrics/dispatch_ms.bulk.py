"""Host seconds of one ``serving_forward`` call (it only enqueues: no sync),
the mean over the traced run's calls outside its profiled window, in ms."""

from benchmark.readers import dispatch_ms


def read(ctx):
    return dispatch_ms(ctx)

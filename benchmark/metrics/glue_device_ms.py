"""Device ms per forward in kernels that are not the port's own (PyTorch's:
ingest, constant vectors, roll and partition copies, cuBLAS), by symbol:
the port's kernels carry p2v:: or an anonymous namespace, PyTorch's at::."""

from benchmark.readers import glue_device_ms


def read(ctx):
    return glue_device_ms(ctx)

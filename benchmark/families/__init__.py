"""One module per model family: the weights the benchmark makes, the
program's set-up and timed call, and the plain reference's answer. A
configuration names its family; the harness imports ``families.<family>``."""

"""The plain reference: plain PyTorch that works out calibration, the
freeze and the integer forward again from the benchmark's own weights and
images. It imports nothing of the program."""

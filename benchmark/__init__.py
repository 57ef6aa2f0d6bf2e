"""The benchmark of the PyTorch and CUDA port (``p2vit_tpu_torch``): see ``run.py``."""

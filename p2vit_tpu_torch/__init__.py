"""p2vit_tpu_torch — the PyTorch/CUDA port of ``p2vit_tpu``.

Power-of-two post-training quantization of ViT/DeiT and int8 serving in
which every requantization is a shift fused into a hand-written CUDA kernel
(``p2vit_tpu_torch/csrc``). The module paths mirror the JAX package's, so
each counterpart is easy to find. This package imports ``torch`` only; the
JAX package stays the reference it is tested against.
"""

__version__ = "0.1.0"

import torch as _torch

# The PoT / PTF searches compare fp32 losses between candidates; TF32 (about
# three decimal digits) would move their argmins. Pin full fp32 for matmuls
# and convolutions, the analogue of the JAX package's
# jax_default_matmul_precision="highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

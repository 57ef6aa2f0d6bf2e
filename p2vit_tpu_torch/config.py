"""Quantization policy (counterpart of ``p2vit_tpu/config.py``)."""

from __future__ import annotations

import dataclasses

from .quant.bit_type import BIT_TYPE_DICT, BitType


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-tensor-class quantization policy; defaults are the reference's."""

    # weight / activation formats; the per-layer bit_config overrides the
    # weight format at inference from the pool {int4, int8}
    bit_type_w: BitType = BIT_TYPE_DICT["int4"]
    bit_type_a: BitType = BIT_TYPE_DICT["int8"]
    # weights: minmax with the PoT search; activations: the CLI method
    observer_w: str = "minmax"
    observer_a: str = "minmax"
    calibration_mode_w: str = "channel_wise"
    calibration_mode_a: str = "layer_wise"
    # Log-Int-Softmax
    int_softmax: bool = True
    bit_type_s: BitType = BIT_TYPE_DICT["uint4"]
    # Power-of-Two-Factor integer LayerNorm
    int_norm: bool = True
    observer_a_ln: str = "ptf"
    calibration_mode_a_ln: str = "channel_wise"
    # SmoothQuant on qkv / fc1
    smoothquant: bool = True
    # the reference's Block passes attn.channel_scale (not mlp's) as norm2's
    # output-quantizer scale; True replicates that
    norm2_attn_channel_scale_compat: bool = True


def make_policy(ptf: bool = True, lis: bool = True, quant_method: str = "minmax") -> QuantPolicy:
    """Policy from the reference CLI triple (ptf, lis, quant_method)."""
    kw = dict(observer_a=quant_method)
    if lis:
        kw.update(int_softmax=True, bit_type_s=BIT_TYPE_DICT["uint4"])
    else:
        kw.update(int_softmax=False, bit_type_s=BIT_TYPE_DICT["uint8"])
    if ptf:
        kw.update(int_norm=True, observer_a_ln="ptf", calibration_mode_a_ln="channel_wise")
    else:
        kw.update(int_norm=False, observer_a_ln=quant_method, calibration_mode_a_ln="layer_wise")
    return QuantPolicy(**kw)

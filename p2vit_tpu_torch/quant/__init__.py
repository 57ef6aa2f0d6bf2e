from .bit_type import (
    BIT_TYPE_DICT,
    BIT_TYPE_LIST,
    EVAL_BIT_POOL,
    EVAL_BIT_TYPES,
    WEIGHT_CALIB_BIT_TYPES,
    BitType,
)
from .fake_quant import (
    act_scale_reshape,
    dequantize,
    fake_quant,
    fake_quant_log2,
    floor_pot_exponent,
    log2_dequantize,
    log2_quantize,
    lp_loss,
    quantize,
    round_to_pot,
    weight_scale_reshape,
)
from .intops import get_mn, int_layernorm, int_softmax, log_int_softmax, log_round
from .observers import (
    EPS,
    MinMaxStats,
    channel_view,
    collect_minmax,
    merge_minmax,
    minmax_pot_act_params,
    minmax_pot_weight_params,
    ptf_params,
)
from .smoothquant import pot_smooth_channel_scale

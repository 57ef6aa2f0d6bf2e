"""Integer format descriptors (counterpart of ``p2vit_tpu/quant/bit_type.py``).

Pure static data: the same five formats, in the same order, as the JAX
package's registry. Order matters: the per-weight-layer calibration loop
iterates ``WEIGHT_CALIB_BIT_TYPES`` and records one distance per entry.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BitType:
    """An integer format: bit width and signedness."""

    bits: int
    signed: bool
    name: str

    @property
    def upper_bound(self) -> int:
        if not self.signed:
            return 2**self.bits - 1
        return 2 ** (self.bits - 1) - 1

    @property
    def lower_bound(self) -> int:
        if not self.signed:
            return 0
        return -(2 ** (self.bits - 1))

    @property
    def range(self) -> int:
        return 2**self.bits


BIT_TYPE_LIST = [
    BitType(3, False, "uint3"),
    BitType(4, False, "uint4"),
    BitType(4, True, "int4"),
    BitType(8, True, "int8"),
    BitType(8, False, "uint8"),
]

BIT_TYPE_DICT = {bt.name: bt for bt in BIT_TYPE_LIST}

# swept during weight calibration: every format but uint8
WEIGHT_CALIB_BIT_TYPES = [bt for bt in BIT_TYPE_LIST if bt.name != "uint8"]

# bit widths a per-layer ``bit_config`` may select at inference
EVAL_BIT_POOL = (4, 8)
EVAL_BIT_TYPES = [BIT_TYPE_DICT["int4"], BIT_TYPE_DICT["int8"]]

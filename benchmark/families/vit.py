"""ViT/DeiT: weights as the port's ``init_params`` lays them out, the
program's default serving path, and the plain reference."""

from __future__ import annotations

from .. import weights as W
from ..reference import intops as ref_io
from ..reference import vit as ref


def param_spec(sizes: dict) -> dict:
    c, p = sizes["embed_dim"], sizes["patch_size"]
    hid = int(c * sizes["mlp_ratio"])
    n = (sizes["img_size"] // p) ** 2 + 1

    def lin(o, i):
        return {"w": W.tn(o, i), "b": W.zeros(o)}

    def ln():
        return {"w": W.ones(c), "b": W.zeros(c)}

    blocks = [{"norm1": ln(), "qkv": lin(3 * c, c), "proj": lin(c, c), "norm2": ln(), "fc1": lin(hid, c),
               "fc2": lin(c, hid)} for _ in range(sizes["depth"])]
    return {"cls_token": W.tn(1, 1, c), "pos_embed": W.tn(1, n, c),
            "patch_embed": lin(c, sizes["in_chans"] * p * p), "blocks": blocks, "norm": ln(),
            "head": lin(sizes["num_classes"], c)}


def _check_quant(q: dict) -> None:
    if not (q["ptf"] and q["lis"] and q["activation_bits"] == 8 and q["calib_iter"] == 1):
        raise NotImplementedError("the reference implements PTF, LIS, 8-bit activations and one calibration batch")


class Program:
    """The port at the CLI's ``--quant`` defaults: calibrate, convert, attach
    the uint8 ingest; ``forward`` is ``serving.serving_forward`` with no flags."""

    def __init__(self, cfgj: dict, params, calib_x):
        from p2vit_tpu_torch import serving
        from p2vit_tpu_torch.config import make_policy
        from p2vit_tpu_torch.models import vit
        from p2vit_tpu_torch.models.common import ViTConfig

        q, pp = cfgj["quant"], cfgj["preprocess"]
        self.cfg = ViTConfig(**cfgj["sizes"])
        policy = make_policy(q["ptf"], q["lis"], q["quant_method"])
        calib = vit.calibrate(params, self.cfg, policy, calib_x)
        self.s = serving.convert(params, calib.qstate, self.cfg, policy, [q["weight_bits"]] * self.cfg.num_matmuls)
        serving.attach_u8_ingest(self.s, pp["mean"], pp["std"])
        self._forward = serving.serving_forward

    def forward(self, x):
        return self._forward(self.s, self.cfg, x)


def reference(cfgj: dict, params, calib_x):
    """The plain reference's forward ``fwd(x, act)``: uint8 images → logits;
    ``act=intops.codes4`` gives the control (4-bit activations)."""
    q, pp = cfgj["quant"], cfgj["preprocess"]
    _check_quant(q)
    cfg = ref.config(cfgj["sizes"])
    s = ref.freeze(params, ref.calibrate(params, cfg, calib_x, a=q["quant_method"]), cfg, q["weight_bits"],
                   pp["mean"], pp["std"])
    return lambda x, act=ref_io.codes8: ref.forward(s, cfg, x, act)

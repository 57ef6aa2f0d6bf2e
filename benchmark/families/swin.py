"""Swin: weights as the port's ``init_params`` lays them out, the program's
default serving path, and the plain reference."""

from __future__ import annotations

from .. import weights as W
from ..reference import intops as ref_io
from ..reference import swin as ref
from .vit import _check_quant


def param_spec(sizes: dict) -> dict:
    ws, c0 = sizes["window_size"], sizes["embed_dim"]
    n_bias = (2 * ws - 1) ** 2
    depths = sizes["depths"]

    def lin(o, i, bias=True):
        return {"w": W.tn(o, i), "b": W.zeros(o) if bias else None}

    def ln(c):
        return {"w": W.ones(c), "b": W.zeros(c)}

    stages = []
    for i, depth in enumerate(depths):
        c = c0 * 2 ** i
        hid = int(c * sizes["mlp_ratio"])
        st = {"blocks": [{"norm1": ln(c), "qkv": lin(3 * c, c), "proj": lin(c, c),
                          "bias_table": W.tn(n_bias, sizes["num_heads"][i]), "norm2": ln(c),
                          "fc1": lin(hid, c), "fc2": lin(c, hid)} for _ in range(depth)]}
        if i < len(depths) - 1:
            st["downsample"] = {"norm": ln(4 * c), "reduction": lin(2 * c, 4 * c, bias=False)}
        stages.append(st)
    nf = c0 * 2 ** (len(depths) - 1)
    return {"patch_embed": lin(c0, sizes["in_chans"] * sizes["patch_size"] ** 2), "patch_norm": ln(c0),
            "stages": stages, "norm": ln(nf), "head": lin(sizes["num_classes"], nf)}


class Program:
    """The port at the CLI's ``--quant`` defaults: calibrate, convert, attach
    the uint8 ingest; ``forward`` is ``serving_swin.serving_forward`` with no flags."""

    def __init__(self, cfgj: dict, params, calib_x):
        from p2vit_tpu_torch import serving_swin
        from p2vit_tpu_torch.config import make_policy
        from p2vit_tpu_torch.models import swin

        q, pp = cfgj["quant"], cfgj["preprocess"]
        sz = dict(cfgj["sizes"], depths=tuple(cfgj["sizes"]["depths"]), num_heads=tuple(cfgj["sizes"]["num_heads"]))
        self.cfg = swin.SwinConfig(**sz)
        self.policy = make_policy(q["ptf"], q["lis"], q["quant_method"])
        self.qstate = swin.calibrate(params, self.cfg, self.policy, calib_x).qstate
        self.s = serving_swin.convert(params, self.qstate, self.cfg, self.policy,
                                      [q["weight_bits"]] * self.cfg.num_matmuls)
        serving_swin.attach_u8_ingest(self.s, pp["mean"], pp["std"])
        self._forward = serving_swin.serving_forward

    def forward(self, x):
        return self._forward(self.s, self.qstate, self.cfg, self.policy, x)


def reference(cfgj: dict, params, calib_x):
    """The plain reference's forward ``fwd(x, act)``: uint8 images → logits;
    ``act=intops.codes4`` gives the control (4-bit activations)."""
    q, pp = cfgj["quant"], cfgj["preprocess"]
    _check_quant(q)
    cfg = ref.config(cfgj["sizes"])
    s = ref.freeze(params, ref.calibrate(params, cfg, calib_x, a=q["quant_method"]), cfg, q["weight_bits"],
                   pp["mean"], pp["std"])
    return lambda x, act=ref_io.codes8: ref.forward(s, cfg, x, act)

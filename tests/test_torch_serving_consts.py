"""The serving forwards' constants formed once, at ``convert``
(``serving.prepare``, ``serving_swin.prepare``), on the CPU at tiny sizes:
a default forward right after ``convert`` forms none (0 ``consts_formed``
on its spans) and gives, bit for bit, the logits of the same state served
with its constants formed per call (the state without ``"consts"``, through
the public wrappers), for ViT and Swin, LIS on and off, the kernels'
wrappers and their plain versions, uint8 and float32 ingest; a per-call
path counts its constants. The tests marked ``cuda`` run on a card
(``python -m pytest --noconftest tests/test_torch_serving_consts.py``) and
skip here: a default forward of DeiT-T and of Swin-T makes no synchronizing
call and forms no constant, and its logits equal the per-call path's and
the plain path's bit for bit."""

import pytest
import torch

from p2vit_tpu_torch import profiling, serving, serving_swin
from p2vit_tpu_torch.config import make_policy
from p2vit_tpu_torch.models import SWIN_ZOO, VIT_ZOO, swin, vit
from p2vit_tpu_torch.models.common import ViTConfig

VIT = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
SWIN = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                       num_heads=(2, 2), window_size=4)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _images(b, size, seed, device="cpu"):
    """Seeded uint8 images and their host normalization in float32."""
    u8 = torch.randint(0, 256, (b, 3, size, size), generator=torch.Generator().manual_seed(seed),
                       dtype=torch.uint8)
    mean, std = (torch.tensor(v).view(1, 3, 1, 1) for v in (MEAN, STD))
    return {"uint8": u8.to(device), "float32": ((u8.to(torch.float32) / 255.0 - mean) / std).to(device)}


def _per_call(s):
    """The state without its prepared constants: served through the public
    wrappers, each forming its constants per call."""
    return {k: v for k, v in s.items() if k != "consts"}


def _recorded(fn):
    """(fn()'s result, its spans' ``consts_formed``, their ``syncs``)."""
    with profiling.recording():
        out = fn()
    recs = profiling.drain()
    assert sum(r.name == profiling.FORWARD for r in recs) == 1
    return (out, sum(r.counts.get("consts_formed", 0) for r in recs),
            sum(r.counts.get("syncs", 0) for r in recs))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


@pytest.fixture(scope="module")
def served():
    """One calibration per family on the host-normalized images, converted
    with uint8 ingest attached: {family: forward(state, x, **flags)}, the
    states, and the images."""
    x = _images(4, 32, 0)
    pv = vit.init_params(0, VIT, device="cpu")
    sv = serving.convert(pv, vit.calibrate(pv, VIT, make_policy(), x["float32"]).qstate, VIT, make_policy(),
                         [4] * VIT.num_matmuls)
    ps = swin.init_params(0, SWIN, device="cpu")
    qs = swin.calibrate(ps, SWIN, make_policy(), x["float32"]).qstate
    ss = serving_swin.convert(ps, qs, SWIN, make_policy(), 4)
    fwd = {"vit": lambda s, t, **kw: serving.serving_forward(s, VIT, t, **kw),
           "swin": lambda s, t, **kw: serving_swin.serving_forward(s, qs, SWIN, make_policy(), t, **kw)}
    states = {"vit": serving.attach_u8_ingest(sv, MEAN, STD), "swin": serving_swin.attach_u8_ingest(ss, MEAN, STD)}
    return fwd, states, _images(3, 32, 1)


@pytest.mark.parametrize("ingest", ["uint8", "float32"])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("family", ["vit", "swin"])
def test_default_forward_forms_no_constants(served, family, lis, use_kernels, ingest):
    fwds, states, images = served
    fwd, s, x = fwds[family], states[family], images[ingest]
    got, formed, _ = _recorded(lambda: fwd(s, x, lis=lis, use_kernels=use_kernels))
    assert formed == 0
    want, formed_per_call, _ = _recorded(lambda: fwd(_per_call(s), x, lis=lis, use_kernels=use_kernels))
    assert formed_per_call > 0
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("family, flags", [("vit", dict(fuse_embed=False, fuse_qkv=False)),
                                           ("swin", dict(fuse_res=False))])
def test_per_call_paths_form_their_constants(served, family, flags):
    """The staged ViT arms and Swin's ``fuse_res=False`` form their
    constants per call (the counter engages) and give the default path's
    logits."""
    fwds, states, images = served
    got, formed, _ = _recorded(lambda: fwds[family](states[family], images["float32"], **flags))
    assert formed > 0
    assert torch.equal(got, fwds[family](states[family], images["float32"]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("ingest", ["uint8", "float32"])
@pytest.mark.parametrize("family", ["deit_tiny", "swin_tiny"])
def test_card_default_forward_makes_no_sync(card, family, ingest):
    """Recording on, which turns PyTorch's sync detector to "warn": a
    default forward counts 0 ``syncs`` and 0 ``consts_formed``; its logits
    equal the per-call path's and the plain path's bit for bit."""
    x = _images(8, 224, 2, card)
    if family == "deit_tiny":
        cfg = VIT_ZOO["deit_tiny_patch16_224"]
        p = vit.init_params(0, cfg, device=card)
        s = serving.convert(p, vit.calibrate(p, cfg, make_policy(), x["float32"]).qstate, cfg, make_policy(),
                            [4] * cfg.num_matmuls)
        serving.attach_u8_ingest(s, MEAN, STD)

        def fwd(state, **kw):
            return serving.serving_forward(state, cfg, x[ingest], **kw)
    else:
        cfg = SWIN_ZOO["swin_tiny_patch4_window7_224"]
        p = swin.init_params(0, cfg, device=card)
        q = swin.calibrate(p, cfg, make_policy(), x["float32"]).qstate
        s = serving_swin.convert(p, q, cfg, make_policy(), 4)
        serving_swin.attach_u8_ingest(s, MEAN, STD)

        def fwd(state, **kw):
            return serving_swin.serving_forward(state, q, cfg, make_policy(), x[ingest], **kw)
    fwd(s)  # the library's build and the plans
    torch.cuda.synchronize()
    got, formed, syncs = _recorded(lambda: fwd(s))
    torch.cuda.synchronize()
    assert (syncs, formed) == (0, 0), profiling.sync_sites()
    assert torch.equal(got, fwd(_per_call(s)))
    assert torch.equal(got, fwd(s, use_kernels=False))

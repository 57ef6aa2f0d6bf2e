"""The port's checkpoint loaders and quant-state file
(``p2vit_tpu_torch/checkpoints.py``) against the JAX package's, bit for bit.

* ``resize_pos_embed`` and ``adapt_input_conv`` on seeded draws;
* the three state-dict loaders through ``load_pretrained``: a timm-style
  ViT ``.pth`` (bare, and in the facebook ``{"model": ...}`` wrapper with a
  ``pos_embed`` on another grid), a Swin ``.pth`` with its index buffers,
  and an AugReg ``.npz``, all built from the JAX package's seeded
  ``init_params`` at TINY size; every leaf equal, and equal to the params
  they were built from where nothing is resized;
* ``load_pretrained``'s FileNotFoundError text.

The quant-state file is tested in ``tests/test_torch_cli.py``, beside the
calibrations the CLI's tests make.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from p2vit_tpu import checkpoints as jck
from p2vit_tpu.models import swin, vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu_torch import checkpoints as tck
from p2vit_tpu_torch import interop
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin

VTINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
TVTINY = tcommon.ViTConfig(**dataclasses.asdict(VTINY))
STINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                        num_heads=(2, 2), window_size=4)
TSTINY = tswin.SwinConfig(**dataclasses.asdict(STINY))


def walk(tree, prefix=""):
    """(path, leaf) of a nested dict/list tree, None leaves included."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_same_tree(got, want):
    g, w = list(walk(got)), list(walk(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        if b is None:
            assert a is None, p
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=p)


# ---------------------------------------------------------------------------
# Shape adaptation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("old,new,tokens", [(7, 4, 1), (4, (6, 5), 1), (14, 14, 0)])
def test_resize_pos_embed_bitwise(old, new, tokens):
    rng = np.random.RandomState(old)
    pos = rng.randn(1, tokens + old * old, 24).astype(np.float32)
    got = tck.resize_pos_embed(pos, new, num_tokens=tokens)
    np.testing.assert_array_equal(got, jck.resize_pos_embed(pos, new, num_tokens=tokens))
    assert got.dtype == np.float32


def test_adapt_input_conv_bitwise():
    rng = np.random.RandomState(2)
    w3 = rng.randn(8, 3, 4, 4).astype(np.float32)
    w6 = rng.randn(8, 6, 4, 4).astype(np.float32)
    for chans, w in ((1, w3), (3, w3), (4, w3), (7, w3), (1, w6)):
        np.testing.assert_array_equal(tck.adapt_input_conv(chans, w), jck.adapt_input_conv(chans, w))
    with pytest.raises(NotImplementedError):
        tck.adapt_input_conv(4, w6)


# ---------------------------------------------------------------------------
# State-dict loaders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vit_params():
    return jax.tree.map(np.asarray, vit.init_params(jax.random.PRNGKey(3), VTINY))


@pytest.fixture(scope="module")
def swin_params():
    return jax.tree.map(np.asarray, swin.init_params(jax.random.PRNGKey(4), STINY))


def vit_state_dict(p, cfg):
    """The timm/DeiT layout of a params tree."""
    c, ps = cfg.embed_dim, cfg.patch_size
    sd = {"cls_token": p["cls_token"], "pos_embed": p["pos_embed"],
          "patch_embed.proj.weight": p["patch_embed"]["w"].reshape(c, cfg.in_chans, ps, ps),
          "patch_embed.proj.bias": p["patch_embed"]["b"],
          "norm.weight": p["norm"]["w"], "norm.bias": p["norm"]["b"],
          "head.weight": p["head"]["w"], "head.bias": p["head"]["b"]}
    names = {"norm1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj", "norm2": "norm2",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i, blk in enumerate(p["blocks"]):
        for key, name in names.items():
            sd[f"blocks.{i}.{name}.weight"] = blk[key]["w"]
            sd[f"blocks.{i}.{name}.bias"] = blk[key]["b"]
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def swin_state_dict(p, cfg):
    """The microsoft/Swin-Transformer layout, with the index buffers real
    checkpoints carry (not loaded)."""
    c = cfg.embed_dim
    sd = {"patch_embed.proj.weight": p["patch_embed"]["w"].reshape(c, 3, cfg.patch_size, cfg.patch_size),
          "patch_embed.proj.bias": p["patch_embed"]["b"],
          "patch_embed.norm.weight": p["patch_norm"]["w"], "patch_embed.norm.bias": p["patch_norm"]["b"],
          "norm.weight": p["norm"]["w"], "norm.bias": p["norm"]["b"],
          "head.weight": p["head"]["w"], "head.bias": p["head"]["b"]}
    names = {"norm1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj", "norm2": "norm2",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i, stage in enumerate(p["stages"]):
        for j, blk in enumerate(stage["blocks"]):
            pre = f"layers.{i}.blocks.{j}."
            for key, name in names.items():
                sd[pre + name + ".weight"] = blk[key]["w"]
                sd[pre + name + ".bias"] = blk[key]["b"]
            sd[pre + "attn.relative_position_bias_table"] = blk["bias_table"]
            sd[pre + "attn.relative_position_index"] = tswin.relative_position_index(TSTINY.window(i))
        if "downsample" in stage:
            ds = stage["downsample"]
            sd[f"layers.{i}.downsample.norm.weight"] = ds["norm"]["w"]
            sd[f"layers.{i}.downsample.norm.bias"] = ds["norm"]["b"]
            sd[f"layers.{i}.downsample.reduction.weight"] = ds["reduction"]["w"]
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def augreg_npz(p, cfg):
    """The Google AugReg Flax layout: HWIO conv, per-head q/k/v kernels,
    (in, out) dense kernels."""
    c, h, ps = cfg.embed_dim, cfg.num_heads, cfg.patch_size
    hd = c // h
    out = {"embedding/kernel": p["patch_embed"]["w"].reshape(c, 3, ps, ps).transpose(2, 3, 1, 0),
           "embedding/bias": p["patch_embed"]["b"], "cls": p["cls_token"],
           "Transformer/posembed_input/pos_embedding": p["pos_embed"],
           "Transformer/encoder_norm/scale": p["norm"]["w"], "Transformer/encoder_norm/bias": p["norm"]["b"],
           "head/kernel": p["head"]["w"].T, "head/bias": p["head"]["b"]}
    for i, blk in enumerate(p["blocks"]):
        b = f"Transformer/encoderblock_{i}/"
        att = b + "MultiHeadDotProductAttention_1/"
        for j, n in enumerate(("query", "key", "value")):
            out[att + f"{n}/kernel"] = blk["qkv"]["w"][j * c:(j + 1) * c].T.reshape(c, h, hd)
            out[att + f"{n}/bias"] = blk["qkv"]["b"][j * c:(j + 1) * c].reshape(h, hd)
        out[att + "out/kernel"] = blk["proj"]["w"].T.reshape(h, hd, c)
        out[att + "out/bias"] = blk["proj"]["b"]
        for ln, key in (("LayerNorm_0", "norm1"), ("LayerNorm_2", "norm2")):
            out[b + ln + "/scale"], out[b + ln + "/bias"] = blk[key]["w"], blk[key]["b"]
        for dn, key in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
            out[b + f"MlpBlock_3/{dn}/kernel"] = blk[key]["w"].T
            out[b + f"MlpBlock_3/{dn}/bias"] = blk[key]["b"]
    return out


def _load_both(name, cfg, tcfg, path):
    return (tck.load_pretrained(name, tcfg, path),
            jax.tree.map(np.asarray, jck.load_pretrained(name, cfg, path)))


@pytest.mark.parametrize("layout", ["bare", "model_wrapper_resized_grid"])
def test_vit_torch_state_dict_bitwise(tmp_path, vit_params, layout):
    sd = vit_state_dict(vit_params, VTINY)
    if layout != "bare":
        rng = np.random.RandomState(5)  # a 6×6 grid: load_pretrained resizes it to TINY's 4×4
        sd["pos_embed"] = torch.from_numpy(rng.randn(1, 37, VTINY.embed_dim).astype(np.float32))
        sd = {"model": sd, "epoch": 300}
    path = str(tmp_path / "deit.pth")
    torch.save(sd, path)
    got, want = _load_both("deit_tiny_patch16_224", VTINY, TVTINY, path)
    assert_same_tree(got, want)
    assert got["pos_embed"].shape == (1, VTINY.seq_len, VTINY.embed_dim)
    if layout == "bare":
        assert_same_tree(got, vit_params)
    tp = interop.params_from_numpy(got, device="cpu")
    assert tp["blocks"][1]["fc2"]["w"].dtype == torch.float32


def test_swin_torch_state_dict_bitwise(tmp_path, swin_params):
    path = str(tmp_path / "swin.pth")
    torch.save(swin_state_dict(swin_params, STINY), path)
    got, want = _load_both("swin_tiny_patch4_window7_224", STINY, TSTINY, path)
    assert_same_tree(got, want)
    assert_same_tree(got, swin_params)
    assert got["stages"][0]["downsample"]["reduction"]["b"] is None


def test_augreg_npz_bitwise(tmp_path, vit_params):
    path = str(tmp_path / "augreg.npz")
    np.savez(path, **augreg_npz(vit_params, VTINY))
    got, want = _load_both("vit_base_patch16_224", VTINY, TVTINY, path)
    assert_same_tree(got, want)
    assert_same_tree(got, vit_params)


def test_load_pretrained_names_the_missing_file(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    for name in ("deit_small_patch16_224", "swin_tiny_patch4_window7_224", "no_such_model"):
        with pytest.raises(FileNotFoundError) as t:
            tck.load_pretrained(name, TVTINY)
        with pytest.raises(FileNotFoundError) as j:
            jck.load_pretrained(name, VTINY)
        assert str(t.value) == str(j.value)
        assert (tck.HUB_FILES.get(name) or "None") in str(t.value)
    assert tck.HUB_FILES == jck.HUB_FILES

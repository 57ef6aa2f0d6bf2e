"""The yardstick's arithmetic: published peaks of the card, and the
operations and bytes of each layer's work computed from a configuration's
sizes and the batch, whatever kernel does the work.

Operations count each product of a multiply-accumulate as 2 (a
multiply and an add); elementwise epilogues, LayerNorms and the softmax are
left out. Bytes count each input read once and each output written once:
int8 codes and weight codes (4-bit codes are stored one to a byte) at 1
byte, float32 vectors at 4.
"""

from __future__ import annotations

# One NVIDIA H100 SXM at its 700 W limit, NVIDIA's data sheet, dense rates
PEAK = {"int8_ops_s": 1979e12, "hbm_bytes_s": 3.35e12}


def least_seconds(calls) -> float:
    """Σ over calls of the larger of ops / int8 peak and bytes / HBM rate."""
    return sum(max(ops / PEAK["int8_ops_s"], nbytes / PEAK["hbm_bytes_s"]) for ops, nbytes in calls)


def gemm(m: int, n: int, k: int):
    """(ops, bytes) of an int8 GEMM with a per-column requant: x, w, out and
    two float32 vectors."""
    return 2 * m * n * k, m * k + n * k + m * n + 8 * n


def vit_calls(sizes: dict, batch: int) -> dict:
    """Per layer, the (ops, bytes) of each call of one forward of ``batch``
    images, in the layers the benchmark names; ``model`` holds every product."""
    c, depth = sizes["embed_dim"], sizes["depth"]
    hid = int(c * sizes["mlp_ratio"])
    g = sizes["img_size"] // sizes["patch_size"]
    n = g * g + 1
    k_patch = sizes["in_chans"] * sizes["patch_size"] ** 2
    m = batch * n
    attn_ops = 4 * batch * n * n * c  # q·kᵀ and weights·v over every head
    qkv_ops = gemm(m, 3 * c, c)[0]
    qkv_attention = [(qkv_ops + attn_ops, m * c + 3 * c * c + 8 * 3 * c + m * c)] * depth
    requant = [gemm(m, hid, c)] * depth + [gemm(batch, sizes["num_classes"], c)]
    model = ([gemm(batch * (n - 1), c, k_patch)]
             + [(qkv_ops + attn_ops, 0), gemm(m, c, c), gemm(m, hid, c), gemm(m, c, hid)] * depth
             + [gemm(batch, sizes["num_classes"], c)])
    return {"model": model, "qkv_attention": qkv_attention, "requant_gemm": requant}


def swin_calls(sizes: dict, batch: int) -> dict:
    """As ``vit_calls`` for Swin: windowed attention products apart from the
    qkv and proj GEMMs, patch merging's reductions, the float stem."""
    c0, ws, p = sizes["embed_dim"], sizes["window_size"], sizes["patch_size"]
    g = sizes["img_size"] // p
    depths, heads = sizes["depths"], sizes["num_heads"]
    stages = len(depths)
    model = [(2 * batch * g * g * sizes["in_chans"] * p * p * c0, 0)]
    window, requant = [], []
    for i, depth in enumerate(depths):
        c, res = c0 * 2 ** i, g // 2 ** i
        w = min(ws, res)
        nwin, n = (res // w) ** 2, w * w
        m = batch * res * res
        hid = int(c * sizes["mlp_ratio"])
        for j in range(depth):
            shifted = j % 2 == 1 and res > ws
            attn_ops = 4 * batch * nwin * n * n * c
            attn_bytes = m * 3 * c + 4 * heads[i] * n * n + (4 * nwin * n * n if shifted else 0) + m * c
            window.append((attn_ops, attn_bytes))
            calls = [gemm(m, 3 * c, c), gemm(m, c, c), gemm(m, hid, c)]
            requant += calls
            if j == depth - 1 and i < stages - 1:
                requant.append(gemm(m, c, hid))  # the plain fc2 before patch merging
            model += calls + [gemm(m, c, hid), (attn_ops, 0)]
        if i < stages - 1:
            red = gemm(m // 4, 2 * c, 4 * c)
            requant.append(red)
            model.append(red)
    head = gemm(batch, sizes["num_classes"], c0 * 2 ** (stages - 1))
    requant.append(head)
    model.append(head)
    return {"model": model, "window_attention": window, "requant_gemm": requant}


CALLS = {"vit": vit_calls, "swin": swin_calls}


def work(family: str, sizes: dict, batch: int) -> dict:
    """{layer: [(ops, bytes), ...]} of one forward at ``batch``."""
    return CALLS[family](sizes, batch)


def model_ops_per_image(family: str, sizes: dict) -> int:
    return sum(ops for ops, _ in work(family, sizes, 1)["model"])

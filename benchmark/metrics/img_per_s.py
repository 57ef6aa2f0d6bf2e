"""Images whose logits reached the host inside the window, per second of it
(host clock; closed-loop cells)."""


def read(ctx):
    r = ctx.result
    return r["images_done"] / r["window_s"] if "images_done" in r else None

"""K1's forward in the train step: the least time of its logical work over
the device time of every attention-forward kernel in the window (percent).

The work, counted here: each step runs the ViT's `depth` blocks, each one
attention forward over the batch at 1 + (size / patch)^2 real tokens (the
class token and the patches), `heads` heads of `width / heads`.
"""

from common import arith, kernels


def read(ctx):
    cfg = ctx.cfg
    size, patch = cfg["image_size"], cfg["published"]["patch_size"]
    n = 1 + (size // patch) ** 2
    heads = cfg["published"]["num_heads"]
    d = cfg["published"]["width"] // heads
    calls = [(ctx.counts["steps"] * cfg["published"]["depth"],
              (ctx.counts["batch"], n, n, heads, d))]
    bound = arith.calls_least_s(calls, arith.attention_fwd)
    return arith.share_pct(bound, ctx.win.kernel_s(kernels.ATTENTION_FWD,
                                                   kernels.ATTENTION_FWD_NOT))

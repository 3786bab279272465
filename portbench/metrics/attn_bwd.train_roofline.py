"""K2's backward in the train step (the dQ and dK/dV kernels): the least
time of the attention backward's logical work over the device time of
every attention-backward kernel in the window (percent).

The work, counted here: each step runs one attention backward a block over
the batch at 1 + (size / patch)^2 real tokens (five products a head, see
`common/arith.py::attention_bwd`).
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
    bound = arith.calls_least_s(calls, arith.attention_bwd)
    return arith.share_pct(bound, ctx.win.kernel_s(kernels.ATTENTION_BWD))

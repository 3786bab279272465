"""The whole MASt3R train step's share of the card's bf16 peak (percent):
model FLOPs of the window's steps (three times the forward's, one pair's
forward counted from the configuration's shapes by `common/flops.py`,
times the pairs) over the traced window's length."""

from common import arith
from common.flops import forward_flops


def read(ctx):
    from drivers.train_pairs import reference_model

    size = ctx.cfg["image_size"]
    fwd = forward_flops(reference_model(ctx.cfg, "meta"), (1, size, size, 3), (1, size, size, 3))
    return arith.mfu_pct(3.0 * fwd * ctx.counts["pairs"], ctx.win.seconds)

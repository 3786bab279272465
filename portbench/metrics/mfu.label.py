"""The whole fused pass's share of the card's bf16 peak (percent): the
depth models' forward FLOPs an image (MoGe at the bucket, DepthPro at 1536
px, counted from the configuration's shapes by `common/flops.py`) times
the window's images, over the traced window's length. The labelling
program's own arithmetic is left out (it is under a thousandth of it)."""

from common import arith
from common.flops import forward_flops


def read(ctx):
    from drivers.label import reference_models

    moge, dp, dp_cfg = reference_models(ctx.cfg, "meta")
    h, w = ctx.cfg["bucket"]
    s = dp_cfg.img_size
    per_image = forward_flops(moge, (1, h, w, 3)) + forward_flops(dp, (1, s, s, 3))
    return arith.mfu_pct(per_image * ctx.counts["images"], ctx.win.seconds)

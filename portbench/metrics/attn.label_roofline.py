"""K1 in the labelling pass: the least time of the attention forwards'
logical work over the device time of every attention-forward kernel in
the window (percent).

The work an image, counted here from the configuration: MoGe's ViT-L at
the bucket, 1 + (h / 14)(w / 14) real tokens, `depth` blocks; DepthPro's
35 patches, one image and one FoV encoder, each a ViT-L/16 at 384 px, 577
real tokens, `depth` blocks. Each block one attention forward of 16 heads
of 64.
"""

from common import arith, kernels


def read(ctx):
    pub = ctx.cfg["published"]
    h, w = ctx.cfg["bucket"]
    m, dp = pub["moge"], pub["depth_pro"]
    n_moge = 1 + (h // m["patch_size"]) * (w // m["patch_size"])
    d = m["width"] // m["num_heads"]
    images = ctx.counts["images"]
    calls = [(images * m["depth"], (1, n_moge, n_moge, m["num_heads"], d)),
             (images * 24 * (dp["patches"] + 2), (1, dp["tokens"], dp["tokens"], 16, 64))]
    bound = arith.calls_least_s(calls, arith.attention_fwd)
    return arith.share_pct(bound, ctx.win.kernel_s(kernels.ATTENTION_FWD,
                                                   kernels.ATTENTION_FWD_NOT))

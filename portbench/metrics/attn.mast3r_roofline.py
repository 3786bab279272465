"""K2's forward in the MASt3R train step: the least time of its logical
work over the device time of every attention-forward kernel in the window
(percent).

The work, counted here from the configuration: each step runs the
encoder's `enc_depth` self-attentions over both views of every pair (2 x
pairs rows) and, at each of the decoder's `dec_depth` depths, a self- and
a cross-attention over its two streams (2 x pairs rows), all at (size /
patch)^2 tokens, heads of `head_dim`.
"""

from common import arith, kernels


def read(ctx):
    pub = ctx.cfg["published"]
    n = (ctx.cfg["image_size"] // pub["patch_size"]) ** 2
    steps, pairs, d = ctx.counts["steps"], ctx.counts["batch_pairs"], pub["head_dim"]
    calls = [(steps * pub["enc_depth"], (2 * pairs, n, n, pub["enc_heads"], d)),
             (steps * 2 * pub["dec_depth"], (2 * pairs, n, n, pub["dec_heads"], d))]
    bound = arith.calls_least_s(calls, arith.attention_fwd)
    return arith.share_pct(bound, ctx.win.kernel_s(kernels.ATTENTION_FWD,
                                                   kernels.ATTENTION_FWD_NOT))

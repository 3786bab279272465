"""K2's backward in the MASt3R train step (the dQ and dK/dV kernels): the
least time of the attention backward's logical work over the device time
of every attention-backward kernel in the window (percent).

The work: one backward for each forward call that
`attn.mast3r_roofline.py` counts (five products a head, see
`common/arith.py::attention_bwd`), counted here the same way.
"""

from common import arith, kernels


def read(ctx):
    pub = ctx.cfg["published"]
    n = (ctx.cfg["image_size"] // pub["patch_size"]) ** 2
    steps, pairs, d = ctx.counts["steps"], ctx.counts["batch_pairs"], pub["head_dim"]
    calls = [(steps * pub["enc_depth"], (2 * pairs, n, n, pub["enc_heads"], d)),
             (steps * 2 * pub["dec_depth"], (2 * pairs, n, n, pub["dec_heads"], d))]
    bound = arith.calls_least_s(calls, arith.attention_bwd)
    return arith.share_pct(bound, ctx.win.kernel_s(kernels.ATTENTION_BWD))

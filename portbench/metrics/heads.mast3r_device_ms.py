"""The device time of the matcher's two catmlp+dpt heads, in the step's
forward, in the MASt3R train step (ms): the median, over the traced
window's steps, of the time between the CUDA events the program records at
the edges of its `matcher.heads` span
(`models/matcher.py::TwoViewMatcher.forward`)."""

from common import program_spans


def read(ctx):
    return program_spans.device_ms(ctx.win, "matcher.heads")

"""The device time of a step's forward, the matcher and the loss, in the
MASt3R train step (ms): the median, over the traced window's steps, of the
time between the CUDA events the program records at the edges of its
`train.forward` span (`parallel/train.py::make_train_step`)."""

from common import program_spans


def read(ctx):
    return program_spans.device_ms(ctx.win, "train.forward")

"""The device time of a step's forward (ms): the model, the loss sums and
the loss. The median, over the traced window's steps, of the time between
the CUDA events the program records at the edges of its `train.forward`
span (`parallel/train.py::make_train_step`)."""

from common import program_spans


def read(ctx):
    return program_spans.device_ms(ctx.win, "train.forward")

"""The card's idle share of the traced train window under the step's
`train.optimizer` span (percent): the window's idle intervals (no kernel,
copy or set running) in which `train.optimizer` is the innermost program
span open on the step's thread, over the window's length. The three
phases' shares sum to at most `idle.train`; the rest falls under
`train.step`'s own time or outside every program span."""

from common import program_spans


def read(ctx):
    return program_spans.idle_share(ctx.win, "train.optimizer", root="train.step")

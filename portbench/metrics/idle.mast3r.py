"""The card's idle share of the traced MASt3R train window (percent): the
time in which no kernel, copy or set ran, over the window's length."""


def read(ctx):
    w = ctx.win.seconds
    return None if w <= 0 else 100.0 * (1.0 - ctx.win.busy_s() / w)

"""The depth backend's device time an image (ms): every kernel launched
between the marker kernels the harness puts around each backend call in
the traced window, over the images the window labelled."""


def read(ctx):
    n = ctx.counts["images"]
    return None if n <= 0 else 1e3 * ctx.win.marked_kernel_s() / n

"""Tiles whose bins reached host memory inside the window, over the
window's seconds."""


def read(run):
    return run.done / run.window_s

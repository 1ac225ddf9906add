"""Images of the steps whose loss reached the host inside the window, over
the window's seconds."""


def read(run):
    return run.done / run.window_s

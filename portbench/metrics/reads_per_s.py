"""Reads of the jobs finished in the window over the window's time."""


def read(ctx):
    return ctx["units"] / ctx["window_s"]

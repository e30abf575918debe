"""Launches of the adaptive band (``banded_align.launches``: one a card
an extender call) per 1,000 reads of the traced window.  A count."""


def read(ctx):
    n = ctx["counters"].get("banded_align.launches", 0)
    if not n or not ctx["units"]:
        return None
    return n / (ctx["units"] / 1e3)

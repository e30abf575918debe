"""Device time of ``dp_adaptive_kernel`` in the trace over the launches of
the adaptive band in the window, in ms."""


def read(ctx):
    t = ctx["trace"]
    n = ctx["counters"].get("banded_align.launches", 0)
    if not t or not n:
        return None
    s = sum(v for k, v in t["ops_s"].items() if "dp_adaptive_kernel" in k)
    return s * 1e3 / n if s > 0 else None

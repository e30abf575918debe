"""Stage 8's wall as the program reports it (``stats["stage_s"]
["correct"]``: the windowed consensus of each new backbone), in ms per
1,000 reads of the traced window, summed over the window's jobs (the
graph job's counter ``stage_s.correct``)."""


def read(ctx):
    s = ctx["counters"].get("stage_s.correct")
    if s is None or not ctx["units"]:
        return None
    return s * 1e3 / (ctx["units"] / 1e3)

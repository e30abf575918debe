"""Stage 6's wall as the program reports it (``stats["stage_s"]
["pagraph"]``: each group's graph build, merges and traversal, the merged
outputs), in ms per 1,000 reads of the traced window, summed over the
window's jobs (the graph job's counter ``stage_s.pagraph``)."""


def read(ctx):
    s = ctx["counters"].get("stage_s.pagraph")
    if s is None or not ctx["units"]:
        return None
    return s * 1e3 / (ctx["units"] / 1e3)

"""Stage 7's wall as the program reports it (``stats["stage_s"]
["align_split"]``: the reads aligned to the new backbones, ``merge.ref``
written), in ms per 1,000 reads of the traced window, summed over the
window's jobs (the graph job's counter ``stage_s.align_split``)."""


def read(ctx):
    s = ctx["counters"].get("stage_s.align_split")
    if s is None or not ctx["units"]:
        return None
    return s * 1e3 / (ctx["units"] / 1e3)

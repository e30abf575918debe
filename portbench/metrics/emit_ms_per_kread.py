"""Host time of the program's ``align.finish`` span (rebuilding the gapped
strings and emitting the records; on the single-device path it also
holds the wait for the batch) per 1,000 reads of the traced window."""


def read(ctx):
    t = ctx["trace"]
    if not t or "align.finish" not in t["spans_s"] or not ctx["units"]:
        return None
    return t["spans_s"]["align.finish"] * 1e3 / (ctx["units"] / 1e3)

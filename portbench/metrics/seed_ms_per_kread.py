"""Host time of the program's ``align.seed`` span per 1,000 reads of the
traced window: on the single-device path the host seeding core, on the
mesh path the seeder calls (queueing the kernels, the copies, the wait
for the candidate tables)."""


def read(ctx):
    t = ctx["trace"]
    if not t or "align.seed" not in t["spans_s"] or not ctx["units"]:
        return None
    return t["spans_s"]["align.seed"] * 1e3 / (ctx["units"] / 1e3)

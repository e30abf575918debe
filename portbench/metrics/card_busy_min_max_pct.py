"""The least busy card's device busy time as a share of the busiest
card's in the traced window, in %: 100 when the cards share the work
evenly."""


def read(ctx):
    t = ctx["trace"]
    if not t or ctx["devices"] < 2 or not t["busy_s"]:
        return None
    busy = [t["busy_s"].get(c, 0.0) for c in range(ctx["devices"])]
    return 100.0 * min(busy) / max(busy) if max(busy) > 0 else None

"""The share of the traced window in which no operation ran on a card
(100 - busy time over the window, in %), the mean over the cell's cards."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["busy_s"] or not t["window_s"]:
        return None
    busy = [t["busy_s"].get(c, 0.0) for c in range(ctx["devices"])]
    return 100.0 * (1.0 - sum(busy) / len(busy) / t["window_s"])

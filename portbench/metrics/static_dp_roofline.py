"""The static band's DP kernel as a share of its roofline: the least time
of the window's DP cells (``dp_cells``, rows run x W; ``roofline.py``)
over the device time of ``dp_static_kernel`` in the trace, in %."""

from portbench import roofline


def read(ctx):
    t = ctx["trace"]
    cells = ctx["counters"].get("dp_cells", 0)
    if not t or not cells:
        return None
    kernel_s = sum(s for n, s in t["ops_s"].items()
                   if "dp_static_kernel" in n)
    if kernel_s <= 0:
        return None
    width = max(ctx["traffic"]["aligner"]["band_width"], 256)
    return 100.0 * roofline.dp_bound_s(cells, width) / kernel_s

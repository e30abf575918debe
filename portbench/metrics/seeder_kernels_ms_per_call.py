"""Device time of the mesh seeder's two kernels (``seed_block_kernel``,
``select_candidates_kernel``) in the trace over the window's launches of
``seed_block``, in ms."""


def read(ctx):
    t = ctx["trace"]
    n = ctx["counters"].get("seed_block.launches", 0)
    if not t or not n:
        return None
    s = sum(v for k, v in t["ops_s"].items()
            if "seed_block_kernel" in k or "select_candidates_kernel" in k)
    return s * 1e3 / n if s > 0 else None

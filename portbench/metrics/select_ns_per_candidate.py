"""Device time of ``select_candidates_kernel`` in the trace over the
candidates its calls weighed in the window (the program's counter
``select.candidates``: a call's reads times their candidates), in ns.
None where the program keeps no such counter."""

from portbench.program_trace import counts


def read(ctx):
    t = ctx["trace"]
    n = counts().get("select.candidates", 0)
    if not t or not n:
        return None
    s = sum(v for k, v in t["ops_s"].items()
            if "select_candidates_kernel" in k)
    return s * 1e9 / n if s > 0 else None

"""Device time of ``seed_block_kernel`` in the trace over the (read
strand, index block) pairs its launches scanned in the window (the
program's counter ``seed.read_blocks``), in ns.  None where the program
keeps no such counter."""

from portbench.program_trace import counts


def read(ctx):
    t = ctx["trace"]
    n = counts().get("seed.read_blocks", 0)
    if not t or not n:
        return None
    s = sum(v for k, v in t["ops_s"].items() if "seed_block_kernel" in k)
    return s * 1e9 / n if s > 0 else None

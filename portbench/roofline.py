"""Peaks of one NVIDIA H100 SXM and the static band's least time.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``INT32_OPS_PER_S``,
``DP_OPS_PER_CELL``, ``dp_bound_ms``) so the yardstick stays as it is
here.

The int32 rate is the Hopper SM's, not a data-sheet figure (the data sheet
gives floating-point and tensor rates only): 132 SMs, each with 4
partitions of 16 int32 lanes (64 int32 operations a clock), at the 1.98
GHz boost clock: 132 x 64 x 1.98e9 = 16.73e12 int32 operations a second.
The bandwidth is the data sheet's 3.35 TB/s of HBM3.  Both assume the
card's full 700 W.
"""

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# a cell of the static band's recurrence: the substitution, 2 adds, 3
# maxima, 4 selects, the gap chain's add and max, the best's compare and 2
# selects, 2 to pack the direction
DP_OPS_PER_CELL = 20


def dp_bound_s(cells: int, width: int) -> float:
    """Least time of the static band's DP over ``cells`` cells (rows run x
    W): the larger of its operations over the int32 rate and its bytes
    over the bandwidth, the bytes being a query base and one new target
    base read a row and the 2-bit directions written.  Each lane's first
    W target bases and its scalars are left out, so the bound is a little
    low, never high."""
    rows = cells // width
    ops_s = cells * DP_OPS_PER_CELL / INT32_OPS_PER_S
    bytes_s = (rows + rows + cells // 4) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s)

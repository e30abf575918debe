"""Measure the adaptive band's kernels against other builds, on one card.

    git show 9e42de1:aligngraph2_tpu_torch/csrc/banded_adaptive.cu > old.cu
    python3 -m aligngraph2_tpu_torch.ops.adaptive_variants --old old.cu

run from the repository root (it takes the lanes of ``chip_smoke.py``).
It builds ``csrc/banded_adaptive.cu``, the source given by ``--old`` (the
kernels before their redesign, with the C interface of that time) and the
variants in :data:`VARIANTS`, each the committed source with a few text
edits made at run time, into the gitignored ``_build/`` directory; no
variant source is kept in the repository.  On the mesh extender's lanes
(B=32, NQ=8192, W=256, x_drop 250, ``chip_smoke.adaptive_lanes`` with its
DIAG lane) it checks that every build's DP and traceback outputs equal the
committed kernels', times each pair of builds in turns (a, b, b, a; CUDA
events, ``--reps`` launches each), and prints the cycles of each phase of
a DP row for lane 0 from copies of the committed and the ``--old`` source
with ``clock64()`` timers (:data:`CLOCKS`), and the instructions of the
W = 256 DP's row loop in the committed build's SASS (``cuobjdump``).  One
JSON line per result, the card's name and power limit first.  Needs CUDA;
nothing on the main path imports this module.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys

# Each variant: (what it changes, [(text, replacement), ...]) on the
# committed source.  Each text must occur exactly once.
VARIANTS = {
    "no_dpx": ("max(a + b, c) as two instructions, not __viaddmax_s32", [
        ("  return __viaddmax_s32(a, b, c);", "  return max(a + b, c);")]),
    "stop_first": ("the lane's stop decided before the next row's chain", [
        ("""    const bool stop =
        i > 0 && (i == last_row ||
                  (xd && !(i < ql && (best == 0 || rmax >= best - x_drop))));
    const int c_row = c;
""", """    if (i > 0 && (i == last_row ||
                  (xd && !(i < ql && (best == 0 || rmax >= best - x_drop))))) {
      const int kb = (i - 1) & (kStage - 1);
      if (lane <= kb) crow[i - kb + lane] = ckeep;
      break;
    }
"""),
        ("""    if (stop) {   // row i - 1 was the last: drop row i
      --i;
      c = c_row;
      const int kb = (i - 1) & (kStage - 1);
      if (lane <= kb) crow[i - kb + lane] = ckeep;
      break;
    }
""", "")]),
    "exclusive_scan": ("the thread total as a tree and the carry as an "
                       "exclusive scan (lanes l-1, l-2, then shifts 2..16)", [
        ("""    H[0] = M[0];
#pragma unroll
    for (int k = 1; k < C; ++k) H[k] = addmax(H[k - 1], gap, M[k]);
    int x = H[C - 1];
#pragma unroll
    for (int e = 1; e < 32; e <<= 1) {
      const int y = __shfl_up_sync(kFull, x, e);
      if (lane >= e) x = addmax(y, gap * C * e, x);
    }
    int carry = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) carry = kNeg;
""", """    int carry;
    {
      int v[C];
#pragma unroll
      for (int k = 0; k < C; ++k) v[k] = M[k] + gap * (C - 1 - k);
      const int T = tree_max(v);
      const int t1 = __shfl_up_sync(kFull, T, 1);
      const int t2 = __shfl_up_sync(kFull, T, 2);
      carry = lane >= 1 ? t1 : kNeg;
      if (lane >= 2) carry = addmax(t2, gap * C, carry);
#pragma unroll
      for (int e = 2; e < 32; e <<= 1) {
        const int y = __shfl_up_sync(kFull, carry, e);
        if (lane >= e) carry = addmax(y, gap * C * e, carry);
      }
    }
    H[0] = M[0];
#pragma unroll
    for (int k = 1; k < C; ++k) H[k] = addmax(H[k - 1], gap, M[k]);
""")]),
    "hoisted_gap_terms": ("gap * C * 2^e and gap * (k + 1) held in "
                          "registers across rows", [
        ("  int best = 0, bi = 0, bj = 0;\n",
         """  int gs[5], gk[C];
#pragma unroll
  for (int e = 0; e < 5; ++e) gs[e] = gap * (C << e);
#pragma unroll
  for (int k = 0; k < C; ++k) gk[k] = gap * (k + 1);
  int best = 0, bi = 0, bj = 0;
"""),
        ("""    for (int e = 1; e < 32; e <<= 1) {
      const int y = __shfl_up_sync(kFull, x, e);
      if (lane >= e) x = addmax(y, gap * C * e, x);
    }""", """    for (int e = 0; e < 5; ++e) {
      const int y = __shfl_up_sync(kFull, x, 1 << e);
      if (lane >= 1 << e) x = addmax(y, gs[e], x);
    }"""),
        ("      int h = addmax(carry, gap * (k + 1), H[k]);",
         "      int h = addmax(carry, gk[k], H[k]);")]),
    "one_lane_a_block": ("one DP lane (warp) a block, not four", [
        ("constexpr int kDpLanes = 4;", "constexpr int kDpLanes = 1;")]),
    "two_lanes_a_block": ("two DP lanes (warps) a block, not four", [
        ("constexpr int kDpLanes = 4;", "constexpr int kDpLanes = 2;")]),
    "all_in_vote": ("a warp vote that skips the NEG mask on rows whose "
                    "cells all lie in the window and qlen", [
        ("""dsh);
""", """dsh);
    const int p0 = base + 1 + j0;
    const bool row_ok = i <= ql;
    const bool all_in =
        __all_sync(kFull, row_ok && p0 >= 0 && p0 + C - 1 <= tl);
"""),
        ("""    const int p0 = base + 1 + j0;
    const bool row_ok = i <= ql;
    int key[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      int h = addmax(carry, gap * (k + 1), H[k]);
      const unsigned at = 8u * (k & 3);
      if (h > M[k]) d[k >> 2] |= (unsigned)kLeft << at;
      const int p = p0 + k;
      const bool ok = row_ok && p >= 0 && p <= tl;
      if (!ok) {
        h = kNeg;
        d[k >> 2] &= ~(0xffu << at);
      }
      H[k] = h;
      key[k] = ok ? (h << kKeyBits) + kc - k : -1;
    }
""", """    int key[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int h = addmax(carry, gap * (k + 1), H[k]);
      if (h > M[k]) d[k >> 2] |= (unsigned)kLeft << (8 * (k & 3));
      H[k] = h;
      key[k] = (h << kKeyBits) + kc - k;
    }
    if (!all_in) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int p = p0 + k;
        if (!(row_ok && p >= 0 && p <= tl)) {
          H[k] = kNeg;
          d[k >> 2] &= ~(0xffu << (8 * (k & 3)));
          key[k] = -1;
        }
      }
    }
""")]),
}

# clock64() phase timers: (text, where) pairs, CLK(k) inserted before
# (or after) each text, for the committed source and for the kernel before
# its redesign; each text must occur exactly once.
_CLK_HEAD = """
__device__ long long g_clk[16];
#define CLK(k) do { long long t_ = clock64(); clk_[k] += t_ - tp_; \\
                    tp_ = t_; } while (0)
"""
_CLK_TAIL = """
extern "C" int agc_read_clk(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(long long) * 16);
}
"""
_CLK_INIT = "  long long clk_[9] = {}; long long tp_ = clock64();\n"
_CLK_SAVE = ("  if (b == 0 && lane == 0) { for (int k = 0; k < 9; ++k) "
             "g_clk[k] = clk_[k]; g_clk[9] = i; }\n")
CLOCKS = {
    "new": (["reduction issued; stage (every 32 rows)",
             "target compares, 3 drifts",
             "reduction's result, best cell, stop", "drift; eq and "
             "predecessor selects", "M and direction codes", "serial prefix",
             "shuffle scan and carry", "fix-up, keys",
             "stores, neighbour shuffles"], [
        ("  int i = 0;         // the last row computed\n", "after", _CLK_INIT),
        ("      qn = qx < NQ ? qrow[qx] : 0u;\n    }\n", "after", "    CLK(0);\n"),
        ("        eqw[k] = __vcmpeq4(__funnelshift_r(w[k], w[k + 1], sh), "
         "qrep);\n    }\n", "after", "    CLK(1);\n"),
        ("    ++i;\n    const int dc = rmax > 0", "before", "    CLK(2);\n"),
        ("    int M[C];\n    unsigned d[NA];\n", "before", "    CLK(3);\n"),
        ("    // gap chain: serial prefix", "before", "    CLK(4);\n"),
        ("    int x = H[C - 1];\n", "before", "    CLK(5);\n"),
        ("    const int p0 = base + 1 + j0;\n", "before", "    CLK(6);\n"),
        ("    if (stop) {", "before", "    CLK(7);\n"),
        ("    rt1 = __shfl_down_sync(kFull, H[1], 1);\n    row_reduce<C, "
         "PACKED>(H, key, j0, ra, rb);\n  }\n", "before", "    CLK(8);\n"),
        ("  cp_async_wait<0>();   // no copy outlives the warp\n", "after",
         _CLK_SAVE)]),
    "old": (["drift, stage (every 32 rows, waits)", "target compare",
             "predecessor shuffles and selects", "M and direction codes",
             "serial prefix", "shuffle scan and carry",
             "fix-up, thread argmax", "stores, two reductions",
             "best cell, x_drop, centres"], [
        ("  int i = 0;\n  while (i < last_row) {\n", "before", _CLK_INIT),
        ("    const unsigned qrep = __shfl_sync(kFull, qv, blk) * "
         "0x01010101u;\n", "before", "    CLK(0);\n"),
        ("        eq[k] = __vcmpeq4(__funnelshift_r(w[k], w[k + 1], sh), "
         "qrep);\n    }\n", "after", "    CLK(1);\n"),
        ("    int M[C];\n    unsigned d[NA];\n", "before", "    CLK(2);\n"),
        ("    // gap chain: serial prefix", "before", "    CLK(3);\n"),
        ("    int x = H[C - 1];\n", "before", "    CLK(4);\n"),
        ("    const int p0 = base + 1 + j0;\n", "before", "    CLK(5);\n"),
        ("    store_dirs<C>(drow + (size_t)(i - 1) * W, d);\n", "before",
         "    CLK(6);\n"),
        ("    row_argmax(tmax, tcol, rmax, rarg);\n    if (rmax > best)",
         "before", "    CLK(7);\n"),
        ("    if (dies) break;\n  }\n", "before", "    CLK(8);\n"),
        ("  if (lane == 0) {\n    score[b] = best;", "before", _CLK_SAVE)]),
}


def edit(src: str, edits) -> str:
    """``src`` with each (text, replacement) applied; each text must occur
    exactly once."""
    for text, new in edits:
        if src.count(text) != 1:
            raise ValueError(f"{src.count(text)} occurrences of {text!r}")
        src = src.replace(text, new)
    return src


def clocked(src: str, kind: str) -> str:
    """``src`` with the clock64() timers of CLOCKS[kind] and a C function
    agc_read_clk that copies them out (phases, then lane 0's rows)."""
    src = edit(src, [("namespace {\n", "namespace {\n" + _CLK_HEAD)])
    for text, where, code in CLOCKS[kind][1]:
        src = edit(src, [(text, text + code if where == "after"
                          else code + text)])
    return src + _CLK_TAIL


def loop_instructions(sass: str, kernel: str) -> int:
    """Instructions of the longest loop of ``kernel`` (a mangled-name
    fragment) in ``cuobjdump -sass`` output: the span of its widest
    unconditional backward branch, 16 bytes an instruction."""
    for body in sass.split("Function : ")[1:]:
        if kernel in body.split("\n", 1)[0]:
            spans = [int(src, 16) - int(dst, 16) for src, dst in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+BRA (?:\S+ )?0x([0-9a-f]+)", body)]
            return max(spans) // 16 + 1
    raise ValueError(f"no function {kernel} in the SASS")


def _build(name: str, src: str, ptxas: dict) -> ctypes.CDLL:
    from . import _cuda
    from ..utils.nativebuild import BUILD_DIR, build_lib, lib_path
    d = os.path.join(BUILD_DIR, "variants")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"adaptive_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = ctypes.CDLL(build_lib(path, _cuda.nvcc_cmd()))
    with open(lib_path(path, _cuda.nvcc_cmd()) + ".log") as f:
        ptxas[name] = [ln.strip() for ln in f if "spill" in ln
                       and "0 bytes spill stores, 0 bytes spill loads"
                       not in ln]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="the kernels' source before their redesign")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("adaptive_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from . import _cuda, banded_dp as bd

    def emit(obj):
        print(json.dumps(obj), flush=True)

    print(cs.nvidia_smi(), flush=True)
    with open(_cuda.ADAPTIVE_SRC) as f:
        new_src = f.read()
    with open(args.old) as f:
        old_src = f.read()
    sources = {"committed": new_src, "old": old_src,
               "committed_clock": clocked(new_src, "new"),
               "old_clock": clocked(old_src, "old")}
    for name, (_, edits) in VARIANTS.items():
        sources[name] = edit(new_src, edits)
    ptxas = {}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        futs = {k: ex.submit(_build, k, v, ptxas)
                for k, v in sources.items()}
        libs = {k: f.result() for k, f in futs.items()}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        old = name.startswith("old")
        lib.agc_dp_adaptive.argtypes = ([ci] + [vp] * 5 + [ci] * (9 if old
                                                                  else 10)
                                        + [vp] * 8)
        lib.agc_tb_adaptive.argtypes = [ci] + [vp] * 4 + [ci] * 5 + [vp] * 5
    emit({"spills": {k: v for k, v in ptxas.items() if v}})
    from ..utils.nativebuild import BUILD_DIR, lib_path
    from torch.utils.cpp_extension import CUDA_HOME
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib_path(
            os.path.join(BUILD_DIR, "variants", "adaptive_committed.cu"),
            _cuda.nvcc_cmd())], capture_output=True, text=True, check=True)
    emit({"sass_dp_256_loop_instructions": loop_instructions(
        sass.stdout, "dp_adaptive_kernelILi256ELb1E")})

    dev = torch.device("cuda")
    B, NQ, W, x_drop = cs.ADAPTIVE_GATE[0]
    NT = NQ + 2 * W
    rng = np.random.default_rng(args.seed)
    lanes = tuple(torch.from_numpy(x).to(dev) for x in cs.diag_lane(
        cs.adaptive_lanes(rng, B, NQ, W), W))
    ref = bd.banded_align(*lanes, W=W, x_drop=x_drop)
    tb_ref = bd.traceback(ref.dirs, ref.centers, ref.best_i, ref.best_j,
                          max_steps=NQ + NT)
    stream = torch.cuda.current_stream().cuda_stream
    c_hi = NT if x_drop else NT + 2 * W + NQ + 4
    q, qlen, t, tlen, c0 = lanes

    def dp(lib, packed):
        out = [torch.empty(B, dtype=torch.int32, device=dev)
               for _ in range(5)]
        dirs = torch.zeros((B, NQ, W), dtype=torch.uint8, device=dev)
        cen = torch.zeros((B, NQ + 1), dtype=torch.int32, device=dev)
        a = [0, q.data_ptr(), t.data_ptr(), qlen.data_ptr(),
             tlen.data_ptr(), c0.data_ptr(), B, NQ, NT, W, c_hi, 2, -4, -3,
             x_drop] + ([] if packed is None else [packed])
        a += [out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
              dirs.data_ptr(), cen.data_ptr(), out[3].data_ptr(),
              out[4].data_ptr(), stream]

        def run():
            _cuda.check(lib, lib.agc_dp_adaptive(*a), "dp")
        return run, (out, dirs)

    def tb(lib):
        stride = -(-(NQ + NT) // 16) * 16
        moves = torch.zeros((B, stride), dtype=torch.uint8, device=dev)
        n, si, sj = (torch.empty(B, dtype=torch.int32, device=dev)
                     for _ in range(3))
        a = [0, ref.dirs.data_ptr(), ref.centers.data_ptr(),
             ref.best_i.data_ptr(), ref.best_j.data_ptr(), B, NQ, W,
             NQ + NT, stride, moves.data_ptr(), n.data_ptr(), si.data_ptr(),
             sj.data_ptr(), stream]

        def run():
            _cuda.check(lib, lib.agc_tb_adaptive(*a), "traceback")
        return run, (moves[:, :NQ + NT], n, si, sj)

    dps, tbs = {}, {}
    for name, lib in libs.items():
        if name.endswith("clock"):
            continue
        packed = None if name == "old" else 1
        dps[name] = dp(lib, packed)
        tbs[name] = tb(lib)
    dps["two_reductions"] = dp(libs["committed"], 0)
    for name in dps:
        dps[name][0]()
        tbs.get(name, tbs["committed"])[0]()
        torch.cuda.synchronize()
        (sc, bi, bj, rows, _), dirs = dps[name][1]
        equal = (torch.equal(sc, ref.score) and torch.equal(bi, ref.best_i)
                 and torch.equal(bj, ref.best_j)
                 and torch.equal(dirs, ref.dirs)
                 and all(torch.equal(x, y) for x, y in
                         zip(tbs.get(name, tbs["committed"])[1], tb_ref)))
        emit({"build": name, "what": VARIANTS.get(name, ("",))[0],
              "equal_to_committed": equal,
              "longest_lane_rows": int(rows.max())})
        if not equal:
            raise SystemExit(f"{name} differs from the committed kernels")
    rows = int(dps["committed"][1][0][3].max())   # the longest lane's
    for a_name, b_name in [("old", "committed"),
                           *(("committed", v) for v in VARIANTS),
                           ("committed", "two_reductions")]:
        ms = [cs.cuda_ms(dps[k][0], args.reps)
              for k in (a_name, b_name, b_name, a_name)]
        emit({"kernel": "dp", "turns": [a_name, b_name, b_name, a_name],
              "ms": ms, "cycles_per_row": [m * 1e-3 * cs.SM_CLOCK_HZ / rows
                                           for m in ms]})
    moves = int(tb_ref[1].max())
    ms = [cs.cuda_ms(tbs[k][0], args.reps)
          for k in ("old", "committed", "committed", "old")]
    emit({"kernel": "traceback", "turns": ["old", "committed", "committed",
                                           "old"], "ms": ms,
          "cycles_per_move": [m * 1e-3 * cs.SM_CLOCK_HZ / moves for m in ms],
          "longest_walk": moves})
    buf = (ctypes.c_longlong * 16)()
    for name, kind in (("committed_clock", "new"), ("old_clock", "old")):
        lib = libs[name]
        lib.agc_read_clk.argtypes = [vp]
        run, _ = dp(lib, None if kind == "old" else 1)
        run()
        torch.cuda.synchronize()
        _cuda.check(lib, lib.agc_read_clk(ctypes.addressof(buf)), "clock")
        n = max(buf[9], 1)
        phases = {p: buf[k] / n for k, p in enumerate(CLOCKS[kind][0])}
        emit({"clock": name, "lane0_rows": buf[9],
              "cycles_per_row": sum(phases.values()),
              "ms": cs.cuda_ms(run, 5), "phases": phases})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The controls of the check: the plain reference put in the program's
place with one thing the configuration states broken, judged by the
comparison that decides ``correct``.

  * ``band_half``: the band cut to half its cells (128 of 256), breaking
    the band the traffic states; the control that must come out not
    correct (the configurations state no precision: every layer is exact
    integer arithmetic);
  * ``int16``: cell scores saturated at 32,767, read beside it: it changes
    only a record whose score passes 32,767, about 25 kb of unbroken
    alignment at this read profile, so on some seeds no checked record
    (see PERF.md).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --reads <reads a window finishes>

For each seed it makes the cell's deployment, takes the window's sample
as a run does (jobs over the first ``--reads`` reads of the pool
finished, the traffic's sample and longest reads drawn from the seed),
runs the
reference as stated and each control over it, and prints one JSON line a
control with the comparison's numbers.  The program is not run: the
control stands where it would.  The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


CONTROLS = {"band_half": {"band_shift": 1}, "int16": {"cap": 32767}}


def control(spec: dict, seed: int, n_reads: int, device,
            kinds=tuple(CONTROLS)) -> list:
    """The comparison's numbers for each control on one seed."""
    from portbench import deployment, harness
    from portbench.reference.align import Reference
    traffic = spec["traffic"]
    dep = deployment.build(spec["config"], seed, traffic["pool_coverage"],
                           {traffic["target"], "reads"})
    reads = dep["reads"]
    chk = traffic["check"]
    sample = harness.Sample(reads, seed, chk["reads"], chk["longest"],
                            traffic["aligner"]["max_read_len"],
                            chk["all_above"])
    jr = traffic["job_reads"]
    for s in range(0, n_reads, jr):
        sample.keep([(s + i) % len(reads) for i in range(jr)])
    rids = sample.pick(set(range(min(n_reads, len(reads)))))
    target = dep[traffic["target"]]
    path = traffic["path"]["kind"]
    want = Reference(target, traffic["aligner"], path, device).align(
        reads, rids)
    longest = max(reads.size(r) for r in rids)
    out = []
    for kind in kinds:
        t0 = time.perf_counter()
        ctl = Reference(target, traffic["aligner"], path, device,
                        **CONTROLS[kind]).align(reads, rids)
        got = {reads.names[r]: t for r, t in ctl.items()}
        check = harness.limits(harness.compare(got, want, reads.names),
                               len(rids), chk["reads"])
        out.append({"control": kind, "seed": seed,
                    "correct": harness.passed(check),
                    "longest_read": longest, "check": check,
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--reads", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness
    spec = harness.cell_spec(harness.load_benchmark(ROOT), args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in control(spec, seed, args.reads, dev):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of the graph-stages cell (``jobs/graph_stages.py``): stage
7's plain reference with the band cut to half its cells (128 of 256) put
in the program's place, judged by the comparison that decides
``correct``.  The cell's backbones come from the program's stage 6, so
the program's set-up runs first (all eight stages from an empty cache,
as a run's warm-up); the sample is the one a window of one job checks.

    python3 portbench/control_graph.py --config ecoli_k12_pacbio \\
        --traffic graph.single --seeds 1,2,3

prints one JSON line a seed.  The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def files_spec(config: str, traffic: str) -> dict:
    """The configuration and traffic files named, as a cell's spec holds
    them (the cell need not be in ``BENCHMARK.json``)."""
    from portbench import harness
    return {"config": harness.read_json("configs", config),
            "traffic": harness.read_json("traffic", traffic)}


def control(spec: dict, seed: int, device) -> list:
    """The comparison's numbers for the band_half control on one seed."""
    from portbench import deployment, harness
    from portbench.jobs.graph_stages import Job
    from portbench.reference.align import Reference
    traffic = spec["traffic"]
    dep = deployment.build(spec["config"], seed, traffic["pool_coverage"],
                           set(traffic["parts"]))
    reads = dep["reads"]
    job = Job(dep, traffic, [device])
    try:
        t0 = time.perf_counter()
        ids = job.warmup_ids("all")
        job.run(ids)
        setup_s = time.perf_counter() - t0
        target = job.backbones
    finally:
        job.close()
    chk = traffic["check"]
    sample = harness.Sample(reads, seed, chk["reads"], chk["longest"],
                            traffic["aligner"]["max_read_len"],
                            chk["all_above"])
    sample.keep(ids)
    rids = sample.pick(set(ids))
    t0 = time.perf_counter()
    want = Reference(target, traffic["aligner"], "single", device).align(
        reads, rids)
    ctl = Reference(target, traffic["aligner"], "single", device,
                    band_shift=1).align(reads, rids)
    got = {reads.names[r]: t for r, t in ctl.items()}
    check = harness.limits(harness.compare(got, want, reads.names),
                           len(rids), chk["reads"])
    return [{"control": "band_half", "seed": seed,
             "correct": harness.passed(check),
             "longest_read": max(reads.size(r) for r in rids),
             "check": check, "setup_s": setup_s,
             "seconds": time.perf_counter() - t0}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    spec = files_spec(args.config, args.traffic)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in control(spec, seed, dev):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark's run of one cell: set-up, a closed-loop window of jobs,
the check against the plain reference, and the metrics.

Everything is found by name.  A cell of ``BENCHMARK.json`` names a
configuration (``configs/<config>.json``: the deployment), a traffic mix
(``traffic/<traffic>.json``: the job kind, its settings, ``job_reads``,
the pool's coverage, the size of the check) and its chips; the job kind
is ``jobs/<job>.py``; each metric is read by ``metrics/<metric>.py``'s
``read(ctx)``, which returns a number or None (nothing to read).

A run:
  1. makes the deployment from the seed (``deployment.py``);
  2. builds the job (the program's aligner and its index) and runs one
     warm-up job; this and everything before it is ``setup_s``;
  3. runs jobs back to back, one caller, until ``seconds`` have passed
     (the pool is the deployment's reads in order, wrapped around), under
     ``torch.profiler`` when traced;
  4. reads the counters and the device's peak memory, frees the
     program's state, and checks a sample of the window's reads, drawn
     from the seed with the longest among them (:class:`Sample`), against
     the reference.

A traffic file may list the deployment's ``parts`` a job needs (default:
its ``target`` and the reads) and give ``job_reads`` as ``"all"`` (each
job takes the whole pool).  A job class that defines ``check()`` adds its
own compared numbers, each with its limit and rule as :func:`limits`
writes them, to the per-read comparison.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import resource
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import deployment, tracing

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names a run may not load (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "aligngraph2_tpu")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: every
    loaded module)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def read_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, name + ".json")) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(bench: dict, name: str) -> dict:
    """The cell ``name`` with its configuration, traffic and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    return {"name": name, "chips": cell["chips"],
            "config": read_json("configs", cell["config"]),
            "traffic": read_json("traffic", cell["traffic"]),
            "end_to_end": [m["name"] for m in bench["end_to_end"]
                           if _applies(m, name)],
            "per_layer": [m["name"] for m in bench["per_layer"]
                          if _applies(m, name)],
            "units": {m["name"]: m["unit"]
                      for m in bench["end_to_end"] + bench["per_layer"]}}


def reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def job_class(kind: str):
    return importlib.import_module(f"{__package__}.jobs.{kind}").Job


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _host_use(a, b) -> tuple:
    """The process's user and system CPU seconds between two
    ``getrusage`` readings: set against a job's wall, they tell a host
    that runs the work slower from a process that waits."""
    return (round(b.ru_utime - a.ru_utime, 2),
            round(b.ru_stime - a.ru_stime, 2))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the check


class Sample:
    """The reads a run checks, drawn from the seed as the window goes, so a
    job's records need not be kept whole: ``n_sample`` drawn from each job
    (the check then draws ``n_sample`` of all those answered), every read
    of a job among the pool's ``4 * n_longest`` longest up to ``max_len``
    (the check takes the ``n_longest`` longest answered), and every read
    longer than ``all_above`` up to ``max_len`` (the check takes all of
    those answered: past the static band's top bucket, the reads that
    take the adaptive band on the single-device path).  A read's first answer in
    a job that drew it is the one checked."""

    def __init__(self, reads, seed: int, n_sample: int, n_longest: int,
                 max_len: int, all_above: int):
        self.seed, self.n_sample, self.n_longest = int(seed), n_sample, \
            n_longest
        self.lens = reads.lengths
        fit = np.flatnonzero(self.lens <= max_len)
        self.longest = set(fit[np.argsort(-self.lens[fit], kind="stable")]
                           [:4 * n_longest].tolist())
        self.always = set(fit[self.lens[fit] > all_above].tolist())
        self.drawn, self.long = [], []
        self.jobs = 0

    def keep(self, ids) -> list:
        """The reads of the next job whose answers the check may take."""
        rng = np.random.default_rng([self.seed, 9, self.jobs])
        self.jobs += 1
        drawn = [ids[i] for i in rng.choice(
            len(ids), size=min(self.n_sample, len(ids)), replace=False)]
        self.drawn += drawn
        long = [r for r in ids if r in self.longest or r in self.always]
        self.long += long
        return drawn + long

    def pick(self, answered) -> list:
        """The reads to check among ``answered``: those kept from the jobs
        that finished."""
        drawn = sorted({r for r in self.drawn if r in answered})
        rng = np.random.default_rng([self.seed, 10])
        pick = set(rng.choice(drawn, size=min(self.n_sample, len(drawn)),
                              replace=False).tolist()) if drawn else set()
        long = sorted({r for r in self.long if r in answered},
                      key=lambda r: -self.lens[r])
        pick.update([r for r in long if r not in pick][:self.n_longest])
        pick.update(r for r in long if r in self.always)
        return sorted(int(r) for r in pick)


def compare(got: dict, want: dict, names) -> dict:
    """Per read, the program's record texts against the reference's:
    counts of differing reads, of records differing in the header line,
    in the strings only, missing and extra."""
    n = dict(reads_differing=0, headers_differing=0, strings_differing=0,
             records_missing=0, records_extra=0)
    first = None
    for rid, ref in want.items():
        prog = got.get(names[rid], [])
        if prog == ref:
            continue
        n["reads_differing"] += 1
        first = first or (names[rid], prog[:2], ref[:2])
        for a, b in zip(prog, ref):
            if a.split("\n")[0] != b.split("\n")[0]:
                n["headers_differing"] += 1
            elif a != b:
                n["strings_differing"] += 1
        n["records_missing"] += max(0, len(ref) - len(prog))
        n["records_extra"] += max(0, len(prog) - len(ref))
    if first is not None:
        name, prog, ref = first
        log(f"first differing read {name}: program "
            f"{[p.split(chr(10))[0] for p in prog]} reference "
            f"{[r.split(chr(10))[0] for r in ref]}")
    return n


def limits(numbers: dict, n_checked: int, n_wanted: int) -> dict:
    """Each compared number with its limit: every count at most 0, and at
    least as many reads checked as the traffic asks for."""
    out = {"reads_checked": {"value": n_checked, "limit": n_wanted,
                             "rule": ">="}}
    for k, v in numbers.items():
        out[k] = {"value": v, "limit": 0, "rule": "<="}
    return out


def passed(check: dict) -> bool:
    return all(c["value"] >= c["limit"] if c["rule"] == ">=" else
               c["value"] <= c["limit"] for c in check.values())


def check_lines(check: dict) -> list:
    return [f"check {k} = {c['value']} (limit {c['rule']} {c['limit']})"
            for k, c in check.items()]


# ---------------------------------------------------------------------------
# a run


def run(spec: dict, seed: int, seconds: float, trace: bool, devices: list,
        t_start: float) -> dict:
    """One run of the cell ``spec`` (see :func:`cell_spec`) on
    ``devices``; returns the result line's object, "check" last."""
    traffic = spec["traffic"]
    on_card = devices[0].type == "cuda"
    parts = (set(traffic["parts"]) if "parts" in traffic
             else {traffic["target"], "reads"})
    dep = deployment.build(spec["config"], seed, traffic["pool_coverage"],
                           parts)
    reads = dep["reads"]
    log(f"deployment: {len(reads)} reads, {int(reads.lengths.sum())} bp; "
        f"{time.perf_counter() - t_start:.1f} s")
    job = job_class(traffic["job"])(dep, traffic, devices)
    # "all": each job takes the whole pool
    job_reads = (len(reads) if traffic["job_reads"] == "all"
                 else traffic["job_reads"])
    job.run(job.warmup_ids(job_reads))
    _sync(devices)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.1f} s")

    chk = traffic["check"]
    sample = Sample(reads, seed, chk["reads"], chk["longest"],
                    traffic["aligner"]["max_read_len"], chk["all_above"])
    before = job.counters()
    got, kept, jobs, attempted, failed, units, pos = {}, set(), 0, 0, 0, 0, 0
    job_ends, host = [], []
    n = len(reads)
    with tracing.traced(trace, on_card) as tr:
        t0 = time.perf_counter()
        while True:
            ids = [(pos + i) % n for i in range(job_reads)]
            pos = (pos + job_reads) % n
            attempted += len(ids)
            jobs += 1
            keep = sample.keep(ids)
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            try:
                out = job.run(ids)
            except Exception:   # a job that fails answers none of its reads
                traceback.print_exc()
                failed += len(ids)
            else:
                units += len(ids)
                # the first answer of each read the check may take
                texts = job.texts(out, {reads.names[r] for r in keep})
                for r in keep:
                    got.setdefault(reads.names[r], texts.get(reads.names[r],
                                                             []))
                    kept.add(r)
                del out
            job_ends.append(time.perf_counter() - t0)
            host.append(_host_use(ru0, resource.getrusage(
                resource.RUSAGE_SELF)))
            if job_ends[-1] >= seconds:
                break
        _sync(devices)
        window_s = time.perf_counter() - t0
    log(f"window {window_s:.2f} s, {jobs} jobs, {units} reads; jobs end "
        f"at {[round(t, 2) for t in job_ends]} s")
    log(f"jobs' host CPU (user s, system s): {host}")
    delta = {k: v - before[k] for k, v in job.counters().items()}
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)
    summary = (tracing.summarize(tr["events"], tr["window_s"]) if trace
               else None)
    tr.clear()
    job.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    rids = sample.pick(kept)
    ref = job.reference(job.ref_device(devices))
    with ThreadPoolExecutor(max_workers=1) as pool:
        # a job's own numbers, with their limits, worked out beside the
        # reference
        own = pool.submit(job.check) if hasattr(job, "check") else None
        want = ref.align(reads, rids)
        numbers = compare(got, want, reads.names)
        numbers["jobs_failed"] = failed // job_reads
        check = limits(numbers, len(rids), chk["reads"])
        if own is not None:
            check.update(own.result())
    log(f"reference: {len(rids)} reads in {time.perf_counter() - t_ref:.1f}"
        f" s; " + ", ".join(f"{k} {v:.1f}" for k, v in ref.times.items()))

    ctx = {"units": units, "window_s": window_s, "setup_s": setup_s,
           "counters": delta, "trace": summary, "devices": len(devices),
           "traffic": traffic}
    metrics = {}
    for name in spec["per_layer"] if trace else spec["end_to_end"]:
        v = reader(name)(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": spec["units"][name]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(devices[0]) if on_card
                       else "cpu"),
              "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": passed(check), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if trace:
        busy = [summary["busy_s"].get(d.index or 0, 0.0) for d in devices]
        device["busy_s"] = sum(busy) / len(busy)
        device["window_s"] = summary["window_s"]
        result["breakdown"] = tracing.breakdown(summary)
    result["check"] = check
    return result

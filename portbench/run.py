"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Exits 2 without a result when CUDA is
missing or the machine has fewer cards than the cell asks for, and 3 when
a module of JAX or of the JAX package was loaded.  The last lines on
standard error are the check's numbers with their limits; the last line on
standard output is the result as one JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed places inside the checkout; no
    # library may bring in JAX through flax
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    from portbench import harness

    spec = harness.cell_spec(harness.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < spec["chips"]:
        harness.log(f"{args.workload} needs {spec['chips']} CUDA card(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    devices = [torch.device("cuda", i) for i in range(spec["chips"])]
    torch.cuda.set_device(devices[0])
    result = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                         devices, T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules loaded that the port may not use: {bad}")
        return 3
    for line in harness.check_lines(result["check"]):
        harness.log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

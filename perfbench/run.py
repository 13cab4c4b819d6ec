"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Builds the port's kernels into the checkout
(`devis_torch/_build/`), sets up the cell through the entry module its
workload file names (`entries/<entry>.py`), measures for
`--seconds` and prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer metrics), `device` (and `breakdown` when
traced), then `checks`: each number the comparison with the plain reference
judged, with its limit. Those numbers are also the last lines of standard
error. Without a CUDA card, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded, it prints no result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json      # noqa: E402
import os        # noqa: E402
import sys       # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("perfbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache the run writes stays in the checkout, at fixed paths
    cache = os.path.join(CHECKOUT, ".perfbench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(cache, "nv"))
    os.environ["USE_FLAX"] = "0"

    import torch
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3

    sys.path.insert(0, HERE)
    import harness
    entry = harness.load("workloads", args.workload)["entry"]
    spec = importlib.util.spec_from_file_location(
        "entry_" + entry, os.path.join(HERE, "entries", entry + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    result = mod.run(args.workload, args.seed, args.seconds, bool(args.trace),
                     device="cuda", t_start=T_START, log=log)
    found = harness.isolation_findings()
    if found:
        log("modules that the run may not load: " + ", ".join(found))
        return 4
    for k, c in result["checks"].items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once and print its result.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic and
its per-layer metrics are found by name from ``BENCHMARK.json``:
``chipbench/traffic/<traffic>.json`` and ``chipbench/metrics/<metric>.py``.
The last line of standard output is the result (JSON); the last lines of
standard error are the numbers the check compared, each beside its limit.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "chipbench"
# every build and kernel cache at a fixed place inside the checkout
CACHES = {"REPRO_TORCH_BUILD_DIR": "build/kernels",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton",
          "CUDA_CACHE_PATH": "build/cuda_cache"}
# one host thread for the program's CPU ops: the process shares its
# host's cores, and intra-op thread pools contending with the serving
# thread spread the tails (p95 spread 10.3% with the default pool, 1.6%
# with one thread, over six 20 s runs on one H100)
HOST_THREADS = {"OMP_NUM_THREADS": "1"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(name: str):
    """-> (workload entry, configuration dict, traffic dict, [(metric, unit,
    reader module)]) from BENCHMARK.json and the files it names."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"({', '.join(sorted(work))})")
    w = work[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    metrics = []
    for m in spec["per_layer"]:
        if name in m.get("workloads", [name]):
            path = BENCH / "metrics" / f"{m['name']}.py"
            mod_spec = importlib.util.spec_from_file_location(
                "chipbench_metric_" + m["name"].replace(".", "_"), path)
            mod = importlib.util.module_from_spec(mod_spec)
            mod_spec.loader.exec_module(mod)
            metrics.append((m["name"], m["unit"], mod))
    return w, config, traffic, metrics


def forbidden_modules() -> list[str]:
    return sorted({n.split(".", 1)[0] for n in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    os.environ.update(HOST_THREADS)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    w, config, traffic, metrics = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from chipbench import bench

    cell = bench.Cell(w["name"], config, traffic, w["chips"], metrics)
    result = bench.run(cell, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace),
                       devices=[f"cuda:{i}" for i in range(w["chips"])],
                       t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

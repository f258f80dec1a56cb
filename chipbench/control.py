"""The readings the check's limits are set from, on the card, at a cell's
own size: the program's numbers over short runs of many seeds (the lower
readings), and the control's (the upper readings).

The control is the plain reference put in the program's place with its
float convolutions in TF32, the step below the float32 that the
configuration states: it serves dispatches of the cell's batch, the same
rows are kept from it as from the program, and the same comparison
judges them.

    python3 chipbench/control.py --workload <name> --program-seeds 12 \
        --control-seeds 3 --seconds 2
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIRST_SEED = 1_000_000_007


def control_numbers(cell, seed: int, device) -> dict:
    """The check's numbers for the TF32 control on ``seed``: as many
    dispatches of the cell's batch as a run keeps forwards, rows kept as a
    run keeps them (as levels)."""
    import numpy as np
    import torch

    from chipbench import bench, check, inputs

    cfg, traffic = cell.config, cell.traffic
    ref = bench.reference_module(cfg)
    batch = traffic["max_batch"] // cell.chips
    gen = inputs.generator(seed, device)
    params = inputs.draw_params(ref.network(cfg), gen)
    pool = inputs.draw_pool(traffic["clients"], cfg["img_hw"],
                            cfg["in_channels"], gen)
    rng = np.random.default_rng(seed)
    n_a = (1 << cfg["a_bits"]) - 1
    kept = []
    with torch.no_grad():
        for _ in range(cell.check_forwards):
            idx = torch.as_tensor(rng.choice(len(pool), batch, replace=False),
                                  device=pool.device)
            hidden, logits = ref.states(params, pool[idx], cfg, tf32=True)
            n = min(cell.check_rows, batch)
            at = int(rng.integers(0, batch - n + 1))
            rows = slice(at, at + n)
            kept.append(dict(x=pool[idx], pool_idx=idx, rows=rows,
                             layers=[torch.round(h[rows] * n_a)
                                     for h in hidden],
                             last_hidden=torch.round(hidden[-1] * n_a),
                             served=logits.float().cpu()))
    numbers = check.compare(ref, params, cfg, kept, pool)
    numbers["missing"] = 0
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chipbench import bench
    from chipbench.run import CACHES, HOST_THREADS, load_cell
    import os

    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    os.environ.update(HOST_THREADS)
    import torch

    w, config, traffic, metrics = load_cell(args.workload)
    if torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA device(s)",
              file=sys.stderr)
        return 2
    cell = bench.Cell(w["name"], config, traffic, w["chips"], [])
    devices = [f"cuda:{i}" for i in range(w["chips"])]
    rows = []
    for i in range(args.program_seeds):
        seed = FIRST_SEED + 7919 * i
        res = bench.run(cell, seed=seed, seconds=args.seconds, trace=False,
                        devices=devices, t_process=time.perf_counter())
        row = dict(side="program", seed=seed, correct=res["correct"],
                   flips_by_layer=res["window"]["flips_by_layer"],
                   images_per_s=res["metrics"]["images_per_s"]["value"],
                   **{k: v["value"] for k, v in res["check"].items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
    for i in range(args.control_seeds):
        seed = FIRST_SEED + 104729 * (i + 1)
        got = control_numbers(cell, seed, torch.device(devices[0]))
        row = dict(side="control", seed=seed, **got)
        rows.append(row)
        print(json.dumps(row), flush=True)
    for k in ("level_flips", "chain_flips", "logit_gap"):
        prog = [r[k] for r in rows if r["side"] == "program"]
        ctl = [r[k] for r in rows if r["side"] == "control"]
        print(json.dumps(dict(number=k, lower=max(prog, default=None),
                              upper=min(ctl, default=None))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Resumable dry-run sweep driver (port of ``repro/launch/sweep.py``): one
subprocess per cell (a fresh process group and bounded memory), one JSON
result per cell, cells whose JSON says ``ok`` skipped.

  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh single --out results/
  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh multi  --out results/

A failed or timed-out cell leaves ``<cell>.json.err`` beside its JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import all_configs


def cell_list():
    cells = []
    for arch, cfg in all_configs().items():
        for cell in cfg.shapes():
            cells.append((arch, cell.name))
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--only", default=None, help="comma list arch:shape")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--analysis", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    cells = cell_list()
    if args.only:
        want = set(tuple(x.split(":")) for x in args.only.split(","))
        cells = [c for c in cells if c in want]

    mesh_tag = "2x16x16" if args.mesh == "multi" else "16x16"
    if args.analysis:
        mesh_tag += "-analysis"
    done = ok = 0
    for arch, shape in cells:
        out_file = os.path.join(args.out, f"{arch}__{shape}__{mesh_tag}.json")
        if os.path.exists(out_file):
            with open(out_file) as f:
                prev = json.load(f)
            if prev and prev[0].get("ok"):
                done += 1
                ok += 1
                continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", out_file]
        if args.mesh == "multi":
            cmd.append("--multi-pod")
        if args.analysis:
            cmd.append("--analysis")
        t0 = time.time()
        print(f"[sweep] {arch} x {shape} ({mesh_tag}) ...", flush=True)
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            status = "OK" if p.returncode == 0 else "FAIL"
            if p.returncode != 0:
                tail = (p.stdout + p.stderr)[-1500:]
                with open(out_file + ".err", "w") as f:
                    f.write(p.stdout + "\n==STDERR==\n" + p.stderr)
                print(f"[sweep]   FAIL tail: ...{tail[-400:]}", flush=True)
            else:
                ok += 1
        except subprocess.TimeoutExpired:
            status = "TIMEOUT"
            with open(out_file + ".err", "w") as f:
                f.write("timeout")
        done += 1
        print(f"[sweep] {arch} x {shape} ({mesh_tag}): {status} "
              f"({time.time()-t0:.0f}s) [{done}/{len(cells)}]", flush=True)
    print(f"[sweep] complete: {ok}/{len(cells)} OK")


if __name__ == "__main__":
    main()

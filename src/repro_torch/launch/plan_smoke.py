"""Plan-cache smoke gate: compile -> save -> reload in a FRESH process ->
logits equal bit for bit, with weight quantization made to raise in the
reloading process (port of ``repro/launch/plan_smoke.py``).

  PYTHONPATH=src python -m repro_torch.launch.plan_smoke [--device cuda] \\
      [--out build/plan_smoke/svhn]

The parent compiles an svhn plan (random weights from a seed) on the
device, saves it and the expected logits, then starts a child
interpreter that reloads the plan and serves the same batch.  The child
patches ``weight_levels`` to raise — in ``repro_torch.core.quant`` and in
``repro_torch.core.prequant``, which binds it by name — proving the
reload never requantizes, and compares the logits bit for bit.  Prints
``PLAN SMOKE OK`` and one JSON line (compile and load milliseconds,
fingerprint, engines) on success.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = 0
IMG = 16
BATCH = 4
CHANNELS = 8


def _setup(device: str):
    import torch

    from repro_torch.core.quant import W1A4
    from repro_torch.models.cnn import init_cnn, svhn_cnn_spec

    spec = svhn_cnn_spec(CHANNELS)
    params = init_cnn(torch.Generator(device=device).manual_seed(SEED), spec)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    x = torch.rand((BATCH, IMG, IMG, 3), generator=gen, device=device)
    return spec, params, x, W1A4


def _sync(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check(base: str, device: str) -> int:
    """Child: reload the plan, forbid requantization, compare bit for
    bit."""
    import numpy as np

    import repro_torch.core.prequant as prequant_mod
    import repro_torch.core.quant as quant_mod
    from repro_torch.core.plan import load_plan, plan_forward

    def _forbidden(*a, **kw):
        raise AssertionError("weight_levels called after a plan reload — "
                             "the plan path must never requantize")

    quant_mod.weight_levels = _forbidden
    prequant_mod.weight_levels = _forbidden
    _, _, x, _ = _setup(device)
    _sync(device)
    t0 = time.perf_counter()
    plan = load_plan(base, device=device)
    _sync(device)
    load_ms = (time.perf_counter() - t0) * 1e3
    out = plan_forward(plan, x).cpu().numpy()
    np.testing.assert_array_equal(out, np.load(base + ".expected.npy"))
    print(f"PLAN SMOKE OK: reload {load_ms:.3f} ms, output bit-identical, "
          f"no requantization (fingerprint {plan.fingerprint()})")
    print("LOAD_MS", json.dumps(load_ms))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/plan_smoke/svhn")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card by default; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--check", default=None, metavar="BASE",
                    help="internal: run the fresh-process reload gate")
    args = ap.parse_args(argv)
    import torch

    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "false (pass --device cpu for the plain versions)")
    if args.check:
        return check(args.check, args.device)

    import numpy as np

    from repro_torch.core.plan import compile_model, plan_forward, save_plan

    spec, params, x, quant = _setup(args.device)
    _sync(args.device)
    t0 = time.perf_counter()
    plan = compile_model(params, spec, quant, batch_hints=(1, BATCH),
                         img_hw=IMG, model="svhn_smoke")
    _sync(args.device)
    compile_ms = (time.perf_counter() - t0) * 1e3
    base = args.out
    save_plan(plan, base)
    np.save(base + ".expected.npy", plan_forward(plan, x).cpu().numpy())
    print(f"compiled plan in {compile_ms:.3f} ms -> {base}.json")

    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.plan_smoke", "--check",
         base, "--device", args.device],
        env=env, capture_output=True, text=True, timeout=600)
    sys.stdout.write(p.stdout)
    sys.stderr.write(p.stderr)
    if p.returncode != 0 or "PLAN SMOKE OK" not in p.stdout:
        print("PLAN SMOKE FAILED", file=sys.stderr)
        return 1
    load_ms = json.loads(p.stdout.split("LOAD_MS", 1)[1].splitlines()[0])
    print(json.dumps(dict(
        plan=base + ".json", device=args.device, compile_ms=compile_ms,
        load_ms=load_ms, fingerprint=plan.fingerprint(),
        engines={lp.name: lp.engine for lp in plan.layers})))
    return 0


if __name__ == "__main__":
    sys.exit(main())

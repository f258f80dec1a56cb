"""How far the (2, 2) mesh trainer's first gradient sits from the meshless
trainer's, in float32 and in bfloat16 compute, leaf by leaf.

chip_smoke's ``DIST`` phase holds the ``(world / 2, 2)`` trainer's step-1
gradients within 2^-3 x max|g| of the meshless run's, in bfloat16 (the
configs' compute type).  This script asks whether that gap is bf16
reduction order: it runs the same case (SmolLM-360M W1A8 at full width
and depth, the DIST phase's first batch, the same params from one
``init_lm`` draw at the mesh's plan) in float32 compute and in bfloat16,
and unquantized in float32 (no 8-bit activation level to flip), one child
process a card (NCCL), and prints for each the gap of every leaf,
relative to that leaf's max|g|.

  python3 dist_precision.py          # on a host with four CUDA cards
  python3 dist_precision.py --cpu    # four gloo ranks, the smoke config

Prints the card's name and power limit, then one ``DIST_PRECISION`` JSON
line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

WORLD = 4
CHILD_TIMEOUT_S = 480


# (name, compute dtype, quant): the DIST phase's bfloat16 W1A8, the same
# in float32, and float32 unquantized (no activation level to flip)
CASES = (("float32", torch.float32, "w1a8"),
         ("bfloat16", torch.bfloat16, "w1a8"),
         ("float32_w32a32", torch.float32, "w32a32"))


def _config(dtype, qname: str, cpu: bool):
    from repro_torch.configs import get_config
    from repro_torch.core.quant import PAPER_CONFIGS

    cfg = get_config("smollm-360m")
    if cpu:
        cfg = cfg.smoke()
    return dataclasses.replace(cfg, quant=PAPER_CONFIGS[qname],
                               compute_dtype=dtype)


def rank_main(rank: int, rdv: str, out: str, cpu: bool) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import SINGLE, make_plan
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    kind = "cpu" if cpu else "cuda"
    if not cpu:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(rank)
    dev = torch.device(kind, 0 if cpu else rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"file://{rdv}", rank=rank,
                            world_size=WORLD)
    L = chip_smoke.DIST_TRAIN
    b = lm_batch(0, 0, batch=L["batch"], seq=L["seq"], vocab=L["data_vocab"],
                 seed=0)
    ocfg = OptConfig(lr=L["lr"], warmup_steps=L["warmup"],
                     total_steps=L["steps"])
    tcfg = TrainConfig(steps=L["steps"])
    mesh = init_device_mesh(kind, (WORLD // 2, 2),
                            mesh_dim_names=("data", "model"))
    plan = make_plan(shd.mesh_sizes(mesh))
    line = {}
    for name, dtype, qname in CASES:
        cfg = _config(dtype, qname, cpu)
        p0 = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, plan,
                       device=dev)
        ref = None
        if rank == 0:
            tr = Trainer(cfg, SINGLE, ocfg, tcfg, device=dev, params=p0,
                         loss_fn=lambda p, bb, cfg=cfg: T.lm_loss(
                             p, bb, cfg, plan))
            loss, _, ref = tr.value_and_grad(tr.place_batch(b))
            ref_loss = float(loss)
            del tr
        dist.barrier()
        tr = Trainer(cfg, plan, ocfg, tcfg, mesh=mesh, params=p0)
        loss, _, g = tr.value_and_grad(tr.place_batch(b))
        loss = float(shd.full_tree(loss))
        g = shd.full_tree(g)
        if rank == 0:
            gap = chip_smoke._grad_gap(g, ref, chip_smoke.DIST_SPLIT_GRAD_TOL)
            per_leaf = {}
            for (k, a), (_, r) in zip(chip_smoke._named(g),
                                      chip_smoke._named(ref), strict=True):
                scale = float(r.float().abs().max())
                per_leaf[k] = float((a.float() - r.float()).abs().max()) / \
                    max(scale, 1e-30)
            line[name] = dict(quant=qname, loss=loss, meshless_loss=ref_loss,
                              loss_rel_diff=abs(loss - ref_loss)
                              / abs(ref_loss), **gap, per_leaf=per_leaf)
        del tr, g, ref, p0
        if not cpu:
            torch.cuda.empty_cache()
    dist.destroy_process_group()
    if rank == 0:
        line.update(arch="smollm-360m" + ("-smoke" if cpu else ""),
                    mesh=[WORLD // 2, 2], batch=L["batch"],
                    seq=L["seq"], data_vocab=L["data_vocab"])
        with open(out, "w") as f:
            json.dump(line, f)


CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import dist_precision
dist_precision.rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                         sys.argv[5] == "cpu")
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="four gloo ranks on the CPU, the smoke config")
    args = ap.parse_args()
    if not args.cpu:
        if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
            print(f"dist_precision: needs {WORLD} CUDA cards", file=sys.stderr)
            return 2
        print("CARD", chip_smoke.card_line(), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="distprec_", dir=os.path.join(ROOT, "build"))
    out = os.path.join(d, "rank0.json")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, ROOT, str(r),
         os.path.join(d, "rendezvous"), out, "cpu" if args.cpu else "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(f"rank {r} exited {p.returncode}:\n{log[-4000:]}",
                  file=sys.stderr)
            return 1
    with open(out) as f:
        line = json.load(f)
    for name, _, _ in CASES:
        r = line[name]
        print(f"{name}: max {r['max_rel']:.3e} at {r['worst_leaf']}, median "
              f"{r['median_rel']:.3e}, min {r['min_rel']:.3e} over "
              f"{r['leaves']} leaves; loss {r['loss']} vs {r['meshless_loss']}")
    print("DIST_PRECISION", json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

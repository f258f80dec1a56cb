"""Training driver (port of ``repro/launch/train.py``): the LM trainer,
on the card unless ``--device cpu``::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --steps 3 --device cpu [--devices 2 [--model 1]]

``--devices 1`` trains on one device under the single-device plan.
``--devices N`` trains over N ranks, one a device (NCCL on the cards,
``gloo`` with ``--device cpu``): spawned here, or one per process when
started by ``torchrun`` (which sets ``RANK``/``WORLD_SIZE``), over
``launch.mesh.make_host_mesh(model=--model)`` and its ``make_plan``.
``--multi-pod`` takes ``launch.mesh.make_production_mesh(multi_pod=True)``
instead, which raises on a world that is not its 512 ranks.  (The
reference takes its 16 x 16 production mesh whenever it sees more than
one device, which no host short of 256 devices can build.)

Batches come from ``data.synthetic.lm_batch`` (seed 0): the whole global
batch on every rank, split over the mesh's ``data`` axis by the trainer;
an encoder's frame features and a VLM's patch embeddings are drawn from
a ``torch.Generator`` seeded with the step.  Only rank 0 logs; ``main``
returns rank 0's history.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import SINGLE, get_config, make_plan
from repro_torch.core.quant import PAPER_CONFIGS
from repro_torch.data.synthetic import lm_batch
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.train.trainer import TrainConfig, Trainer


def make_batch_fn(cfg, batch: int, seq: int, device):
    """``bf(step, micro)``: the step's ``lm_batch`` as tensors on
    ``device``, with frame features (encoder) or patch embeddings (VLM)
    drawn N(0, 1) from a generator seeded with the step."""
    def bf(s, m):
        b = lm_batch(s, m, batch=batch, seq=seq, vocab=cfg.vocab, seed=0)
        out = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        gen = torch.Generator(device=device).manual_seed(s)
        if cfg.frame_input:
            out = dict(frame_feats=torch.randn(
                (batch, seq, cfg.frame_dim), generator=gen, device=device),
                labels=out["labels"])
        if cfg.n_patches:
            out["patch_embeds"] = torch.randn(
                (batch, cfg.n_patches, cfg.vit_dim), generator=gen,
                device=device)
        return out

    return bf


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--quant", default=None, choices=list(PAPER_CONFIGS))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device type (the card by default)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to train over, one a device")
    ap.add_argument("--model", type=int, default=1,
                    help="the mesh's 'model' (tensor-parallel) axis size")
    ap.add_argument("--multi-pod", action="store_true",
                    help="train over launch.mesh.make_production_mesh("
                         "multi_pod=True), the 2 x 16 x 16 mesh of 512 ranks")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "false; pass --device cpu to train on the CPU")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        return _train(args, int(os.environ["RANK"]),
                      int(os.environ["WORLD_SIZE"]), "env://")
    if args.devices == 1:
        return _train(args, 0, 1, None)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        out = ctx.SimpleQueue()
        mp.spawn(_rank_main, args=(args, f"file://{tmp}/rendezvous", out),
                 nprocs=args.devices, join=True)
        return out.get()


def _rank_main(rank: int, args, init_method: str, out) -> None:
    hist = _train(args, rank, args.devices, init_method)
    if rank == 0:
        out.put(hist)


def _train(args, rank: int, world: int, init_method):
    """One rank's run (``init_method`` None: one device, no process
    group) -> its history."""
    dist = torch.distributed
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.quant:
        cfg = dataclasses.replace(cfg, quant=PAPER_CONFIGS[args.quant])
    mesh, plan = None, SINGLE
    if init_method is not None:
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local)
            device = torch.device("cuda", local)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=init_method, rank=rank, world_size=world)
    try:
        if init_method is not None or args.multi_pod:
            from repro_torch.launch import mesh as M

            mesh = (M.make_production_mesh(multi_pod=True,
                                           device_type=device.type)
                    if args.multi_pod else
                    M.make_host_mesh(model=args.model,
                                     device_type=device.type))
            plan = make_plan(M.mesh_shape_dict(mesh))
        tr = Trainer(cfg, plan,
                     OptConfig(lr=args.lr, warmup_steps=10,
                               total_steps=args.steps),
                     TrainConfig(steps=args.steps, log_every=10,
                                 ckpt_every=50,
                                 compress_grads=args.compress_grads),
                     ckpt_dir=args.ckpt_dir, device=device, mesh=mesh)
        log = print if rank == 0 else (lambda *a, **k: None)
        if args.ckpt_dir and tr.restore():
            log(f"resumed from step {tr.step}")
        n = sum(p.numel() for p in tree_leaves(tr.params))
        log(f"arch={cfg.name} quant={cfg.quant.tag()} device={device} "
            f"devices={world} params={n}")
        return tr.run(make_batch_fn(cfg, args.batch, args.seq, device),
                      log=log)
    finally:
        if init_method is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

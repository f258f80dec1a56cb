"""Training driver (port of ``repro/launch/train.py``): the LM trainer on
one device, the card unless ``--device cpu``::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --steps 3 --device cpu

Batches come from ``data.synthetic.lm_batch`` (seed 0); an encoder's
frame features and a VLM's patch embeddings are drawn from a
``torch.Generator`` seeded with the step.  Asking for more than one
device raises: multi-device training comes with the distributed slice.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import SINGLE, get_config
from repro_torch.core.quant import PAPER_CONFIGS
from repro_torch.data.synthetic import lm_batch
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.train.trainer import DISTRIBUTED_SLICE, TrainConfig, Trainer


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


def main(argv=None):
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
                    help="torch device (the card by default)")
    ap.add_argument("--devices", type=int, default=1,
                    help="devices to train on (one: the port trains on one "
                         "device)")
    args = ap.parse_args(argv)

    if args.devices > 1:
        raise SystemExit(f"--devices {args.devices}: " + DISTRIBUTED_SLICE)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "false; pass --device cpu to train on the CPU")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.quant:
        cfg = dataclasses.replace(cfg, quant=PAPER_CONFIGS[args.quant])

    tr = Trainer(cfg, SINGLE,
                 OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps),
                 TrainConfig(steps=args.steps, log_every=10, ckpt_every=50,
                             compress_grads=args.compress_grads),
                 ckpt_dir=args.ckpt_dir, device=device)
    if args.ckpt_dir and tr.restore():
        print(f"resumed from step {tr.step}")
    print(f"arch={cfg.name} quant={cfg.quant.tag()} device={device} "
          f"params={sum(p.numel() for p in tree_leaves(tr.params))}")
    return tr.run(make_batch_fn(cfg, args.batch, args.seq, device))


if __name__ == "__main__":
    main()

"""The LM trainer (port of ``repro/train/trainer.py``): one step is the
loss, ``torch.autograd.grad``, optional gradient compression and
:func:`~repro_torch.train.optimizer.apply_updates`; with checkpoints and
restore.  It runs on one device, the card unless the caller passes
``device="cpu"``; a sharding plan over several devices raises, naming the
distributed slice that brings it.

:class:`~repro_torch.train.intermittent.IntermittentTrainer` is the
power-failure harness over the same gradient step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models import transformer as T
from . import optimizer as opt_mod
from .checkpoint import Checkpointer
from .compression import compressed_allreduce, init_error_feedback
from .optimizer import tree_leaves, tree_map, tree_unflatten

DISTRIBUTED_SLICE = ("training over several devices comes with the "
                     "distributed slice (distributed/sharding: DTensor or "
                     "FSDP; distributed/pipeline over torch.distributed)")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    compress_grads: bool = False
    compress_bits: int = 8


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (v.to(device) if torch.is_tensor(v)
                else torch.from_numpy(np.asarray(v)).to(device))
            for k, v in batch.items() if v is not None}


def trainable(params):
    """The float leaves of ``params`` made leaf tensors that require grad
    (the optimizer returns new tensors without grad)."""
    def one(p):
        if not p.is_floating_point():
            return p
        return p.detach().requires_grad_()
    return tree_map(one, params)


def value_and_grad(loss_fn, params, batch):
    """``loss_fn(params, batch) -> (loss, metrics)`` and the gradient of
    the loss with respect to every float leaf of ``params`` (zeros for a
    leaf the loss does not reach, as ``jax.grad`` gives) -> ``(loss,
    metrics, grads)``, all detached."""
    loss, metrics = loss_fn(params, batch)
    leaves = [p for p in tree_leaves(params) if p.requires_grad]
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(p):
        if not p.requires_grad:
            return torch.zeros_like(p)
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    out = tree_unflatten(params, [grad_of(p) for p in tree_leaves(params)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}, out)


class Trainer:
    """``Trainer(cfg, plan, opt_cfg, tcfg, ckpt_dir=None, loss_fn=None,
    device=None, params=None)``: params from ``params`` (a float tree,
    e.g. the reference's carried across with
    ``convert.lm_train_params_from_numpy``) or else the port's
    ``init_lm`` from seed 0 on ``device`` (default: the card)."""

    def __init__(self, cfg, plan, opt_cfg: opt_mod.OptConfig,
                 tcfg: TrainConfig, ckpt_dir: Optional[str] = None,
                 loss_fn=None, device=None, params=None):
        if plan.tp != 1:
            raise NotImplementedError(f"plan tp={plan.tp}: "
                                      + DISTRIBUTED_SLICE)
        self.cfg, self.plan = cfg, plan
        self.opt_cfg, self.tcfg = opt_cfg, tcfg
        self.loss_fn = loss_fn or (lambda p, b: T.lm_loss(p, b, cfg, plan))
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.step = 0
        if params is None:
            dev = torch.device(device or "cuda")
            params = T.init_lm(torch.Generator(device=dev).manual_seed(0),
                               cfg, plan, device=dev)
        self.params = trainable(params)
        self.device = tree_leaves(self.params)[0].device
        self.opt_state = opt_mod.init_opt_state(self.params, opt_cfg)
        self.ef = (init_error_feedback(self.params)
                   if tcfg.compress_grads else None)

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on ``batch`` (already on the device) ->
        metrics as 0-d tensors: loss, aux, acc, lr, grad_norm."""
        _, metrics, grads = value_and_grad(self.loss_fn, self.params, batch)
        if self.tcfg.compress_grads:
            grads, self.ef = compressed_allreduce(
                grads, self.ef, bits=self.tcfg.compress_bits)
        params, self.opt_state, stats = opt_mod.apply_updates(
            self.params, grads, self.opt_state, self.opt_cfg)
        del grads
        self.params = trainable(params)
        return {**metrics, **stats}

    def restore(self) -> bool:
        if not self.ckpt:
            return False
        st = dict(params=self.params, opt=self.opt_state)
        step, restored = self.ckpt.restore(st)
        if restored is None:
            return False
        self.params = trainable(restored["params"])
        self.opt_state = restored["opt"]
        self.step = step
        return True

    def run(self, batch_fn: Callable[[int, int], Any], log=print) -> list:
        """Train until ``tcfg.steps``: ``batch_fn(step, 0)`` gives each
        step's batch.  Returns the history of logged steps (the first and
        every ``log_every``-th), each with loss, aux, acc, grad_norm, lr,
        step and sps; checkpoints every ``ckpt_every`` steps."""
        history = []
        t0 = time.time()
        while self.step < self.tcfg.steps:
            batch = to_device(batch_fn(self.step, 0), self.device)
            m = self.train_step(batch)
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or self.step == 1:
                m = {k: float(v) for k, v in m.items()}  # repro-lint: disable=RL002 — a logged step's metrics go to the host
                m["step"] = self.step
                m["sps"] = self.step / (time.time() - t0)
                history.append(m)
                log(f"step {self.step}: loss={m['loss']:.4f} "
                    f"acc={m.get('acc', 0):.3f} gnorm={m['grad_norm']:.2f}")
            if self.ckpt and self.step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(self.step,
                               dict(params=self.params, opt=self.opt_state))
        if self.ckpt:
            self.ckpt.wait()
        return history

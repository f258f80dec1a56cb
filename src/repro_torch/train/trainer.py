"""The LM trainer (port of ``repro/train/trainer.py``): one step is the
loss, ``torch.autograd.grad``, optional gradient compression and
:func:`~repro_torch.train.optimizer.apply_updates`; with checkpoints and
restore.  Without a mesh it runs on one device, the card unless the caller
passes ``device="cpu"``.  With ``mesh`` (a ``DeviceMesh`` with ``data``
and ``model`` axes, one rank per device) the params, the optimizer state
and the batch are DTensors placed by ``distributed.sharding`` (the ZeRO
``embed -> data`` rule, the TP rules at ``model > 1``, the batch over
``data``) and the step is the same code on them: the params are gathered
over ``data`` at use (``sharding.at_use``), the model axis stays split,
and DTensor issues the collectives.

:class:`~repro_torch.train.intermittent.IntermittentTrainer` is the
power-failure harness over the same gradient step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as T
from . import optimizer as opt_mod
from .checkpoint import Checkpointer
from .compression import compressed_allreduce, init_error_feedback
from .optimizer import tree_leaves, tree_map, tree_unflatten

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
    device=None, params=None, mesh=None)``: params from ``params`` (a
    float tree, e.g. the reference's carried across with
    ``convert.lm_train_params_from_numpy``; the same on every rank) or
    else the port's ``init_lm`` from seed 0 on ``device`` (default: the
    card; with a mesh, this rank's device on it).  With ``mesh`` they are
    placed by ``sharding.tree_shardings`` under ``plan``
    (``configs.make_plan`` of the mesh's shape); a plan with ``tp > 1``
    needs one."""

    def __init__(self, cfg, plan, opt_cfg: opt_mod.OptConfig,
                 tcfg: TrainConfig, ckpt_dir: Optional[str] = None,
                 loss_fn=None, device=None, params=None, mesh=None):
        if plan.tp != 1 and mesh is None:
            raise ValueError(
                f"plan tp={plan.tp} splits the model over a 'model' mesh "
                "axis: pass mesh= (a DeviceMesh with that axis, e.g. "
                f"launch.mesh.make_host_mesh(model={plan.tp}))")
        self.cfg, self.plan, self.mesh = cfg, plan, mesh
        self.opt_cfg, self.tcfg = opt_cfg, tcfg
        self.loss_fn = loss_fn or (lambda p, b: T.lm_loss(p, b, cfg, plan))
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.step = 0
        if mesh is not None:
            device = shd.local_device(mesh)
        if params is None:
            dev = torch.device(device or "cuda")
            params = T.init_lm(torch.Generator(device=dev).manual_seed(0),
                               cfg, plan, device=dev)
        if mesh is not None:
            self.shardings = shd.tree_shardings(
                params, T.lm_param_axes(cfg, plan), plan, mesh, cfg)
            params = shd.distribute_tree(params, self.shardings, mesh)
        self.params = trainable(params)
        self.device = (device if mesh is not None
                       else tree_leaves(self.params)[0].device)
        self.opt_state = opt_mod.init_opt_state(self.params, opt_cfg)
        self.ef = (init_error_feedback(self.params)
                   if tcfg.compress_grads else None)

    def place_batch(self, batch: dict) -> dict:
        """A batch (numpy arrays or tensors, the whole global batch on
        every rank) on this trainer's device; with a mesh, dim 0 split
        over the batch axes (``sharding.batch_shardings``)."""
        batch = to_device(batch, self.device)
        if self.mesh is None:
            return batch
        return shd.distribute_tree(
            batch, shd.batch_shardings(batch, self.plan, self.mesh),
            self.mesh)

    def _loss(self, params, batch):
        if self.mesh is not None:
            params = shd.at_use(params, self.mesh)
        return self.loss_fn(params, batch)

    def _ctx(self):
        return (shd.on_mesh() if self.mesh is not None
                else contextlib.nullcontext())

    def value_and_grad(self, batch: dict):
        """``(loss, metrics, grads)`` of this trainer's loss at its params
        on a placed batch, as :meth:`train_step` computes them (with a
        mesh: DTensor gradients in the params' placements)."""
        with self._ctx():
            return value_and_grad(self._loss, self.params, batch)

    def apply_grads(self, grads) -> dict:
        """The optimizer step on ``grads`` (as :meth:`value_and_grad`
        gives them; compressed first under ``tcfg.compress_grads``) ->
        its stats (lr, grad_norm) as 0-d tensors."""
        with self._ctx():
            if self.tcfg.compress_grads:
                grads, self.ef = compressed_allreduce(
                    grads, self.ef, bits=self.tcfg.compress_bits)
            params, self.opt_state, stats = opt_mod.apply_updates(
                self.params, grads, self.opt_state, self.opt_cfg)
            self.params = trainable(params)
        return stats

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on ``batch`` (already placed: on the device,
        or with a mesh by :meth:`place_batch`) -> metrics as 0-d tensors
        (full tensors on every rank): loss, aux, acc, lr, grad_norm."""
        _, metrics, grads = self.value_and_grad(batch)
        return shd.full_tree({**metrics, **self.apply_grads(grads)})

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
            batch = self.place_batch(batch_fn(self.step, 0))
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

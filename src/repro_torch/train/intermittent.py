"""Power-intermittency-resilient training (port of
``repro/train/intermittent.py``) — the NV full adder adapted to a
training step.

Paper §II-B3: non-volatile full adders retain the partial accumulation
state, so a power failure loses only the in-flight add, and full NV
writes happen every fixed number of frames.  Here gradient-accumulation
microbatches are the partial sums: the trainer snapshots (microbatch
index, gradient accumulator, loss sum) every ``snapshot_every``
microbatches under tag ``accum``, and full (params + optimizer)
checkpoints every ``full_every`` steps under tag ``full``.  After a
failure the step resumes mid-accumulation, and the final params equal an
uninterrupted run's bit for bit: the data is addressed by (step, micro),
the accumulation order is the reference's, restores land on the params'
device, and on the card the step runs inside
:func:`deterministic_algorithms` (which needs
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment before CUDA
starts: PyTorch raises at the first cuBLAS call without it).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from . import optimizer as opt_mod
from .checkpoint import Checkpointer
from .optimizer import tree_leaves, tree_map
from .trainer import to_device, trainable, value_and_grad


class PowerFailure(RuntimeError):
    """Injected by tests and chaos harnesses to simulate a power loss."""


@dataclasses.dataclass
class IntermittentConfig:
    accum_steps: int = 8          # microbatches per optimizer step
    snapshot_every: int = 2       # NV-FA analogue period (microbatches)
    full_every: int = 10          # full checkpoint period (steps)


@contextlib.contextmanager
def deterministic_algorithms():
    """Deterministic kernels for the duration (cuDNN's deterministic
    algorithms, no autotuning benchmark, and PyTorch's deterministic mode,
    which raises where an op has no deterministic form); the previous
    settings are put back after."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.backends.cudnn.benchmark = prev[1]
        torch.backends.cudnn.deterministic = prev[2]


class IntermittentTrainer:
    """Microbatched trainer with mid-step restartability.

    ``loss_fn(params, microbatch) -> (loss, metrics)``; gradients are
    averaged over ``accum_steps`` microbatches from ``batch_fn(step,
    micro_idx)`` (numpy arrays or tensors, moved to the params' device).
    ``fail_at`` is a set of ``(step, micro)`` where a :class:`PowerFailure`
    is raised (each discarded as it fires)."""

    def __init__(self, loss_fn, params, opt_cfg: opt_mod.OptConfig,
                 batch_fn: Callable[[int, int], Any],
                 ckpt: Checkpointer, icfg: IntermittentConfig,
                 fail_at: Optional[set] = None):
        self.loss_fn = loss_fn
        self.opt_cfg = opt_cfg
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.icfg = icfg
        self.fail_at = fail_at if fail_at is not None else set()
        self.params = trainable(params)
        self.device = tree_leaves(self.params)[0].device
        self.opt_state = opt_mod.init_opt_state(self.params, opt_cfg)
        self.step = 0
        self._pending = None

    def _zero_grads(self):
        return tree_map(lambda p: torch.zeros_like(p, requires_grad=False),
                        self.params)

    # -- persistence ---------------------------------------------------------
    def _train_state(self) -> dict:
        return dict(params=self.params, opt=self.opt_state)

    def save_full(self):
        self.ckpt.save(self.step, self._train_state(), tag="full")

    def restore(self) -> bool:
        """Restore the latest full checkpoint and any newer accumulation
        snapshot (kept pending until :meth:`train` resumes it)."""
        step, st = self.ckpt.restore(self._train_state(), tag="full")
        restored = False
        if st is not None:
            self.params = trainable(st["params"])
            self.opt_state = st["opt"]
            self.step = step
            restored = True
        snap_step = self.ckpt.latest_step(tag="accum")
        if snap_step is not None and snap_step >= self.step:
            template = dict(accum=self._zero_grads(),
                            micro=torch.zeros((), dtype=torch.int32),
                            loss_sum=torch.zeros((), dtype=torch.float64))
            _, snap = self.ckpt.restore(template, step=snap_step, tag="accum")
            self._pending = (snap_step, int(snap["micro"]), snap["accum"],
                             float(snap["loss_sum"]))
            restored = True
        else:
            self._pending = None
        return restored

    # -- the step ------------------------------------------------------------
    def _run_step(self, resume_micro: int = 0, accum=None,
                  loss_sum: float = 0.0) -> dict:
        icfg = self.icfg
        accum = accum if accum is not None else self._zero_grads()
        for mi in range(resume_micro, icfg.accum_steps):
            if (self.step, mi) in self.fail_at:
                self.fail_at.discard((self.step, mi))
                raise PowerFailure(f"power lost at step {self.step} "
                                   f"micro {mi}")
            batch = to_device(self.batch_fn(self.step, mi), self.device)
            loss, _, grads = value_and_grad(self.loss_fn, self.params, batch)
            accum = tree_map(torch.add, accum, grads)
            del grads
            loss_sum = loss_sum + float(loss)  # repro-lint: disable=RL002 — the snapshot's loss sum lives on the host
            nxt = mi + 1
            if nxt % icfg.snapshot_every == 0 and nxt < icfg.accum_steps:
                # the NV-FA write: persist the partial accumulation
                self.ckpt.save(self.step, dict(
                    accum=accum, micro=torch.tensor(nxt, dtype=torch.int32),
                    loss_sum=torch.tensor(loss_sum, dtype=torch.float64)),
                    tag="accum")
                self.ckpt.wait()
        grads = tree_map(lambda g: g / icfg.accum_steps, accum)
        params, self.opt_state, stats = opt_mod.apply_updates(
            self.params, grads, self.opt_state, self.opt_cfg)
        self.params = trainable(params)
        self.step += 1
        return dict(loss=loss_sum / icfg.accum_steps, **stats)

    def train(self, n_steps: int):
        """Run to ``n_steps``; raises PowerFailure when one is injected
        (the caller restarts)."""
        metrics = None
        pend = self._pending
        if pend is not None and pend[0] == self.step:
            _, micro, accum, loss_sum = pend
            self._pending = None
            metrics = self._run_step(micro, accum, loss_sum)
            if self.step % self.icfg.full_every == 0:
                self.save_full()
        while self.step < n_steps:
            metrics = self._run_step()
            if self.step % self.icfg.full_every == 0:
                self.save_full()
        self.ckpt.wait()
        return metrics


def run_with_failures(make_trainer, n_steps: int, max_restarts: int = 64):
    """Chaos harness: restart on each failure (the battery-less node's cold
    boot: a new trainer, then :meth:`IntermittentTrainer.restore`) ->
    ``(trainer, last metrics, restarts)``."""
    restarts = 0
    trainer = make_trainer()
    trainer.restore()
    while True:
        try:
            out = trainer.train(n_steps)
            trainer.save_full()
            trainer.ckpt.wait()
            return trainer, out, restarts
        except PowerFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            trainer = make_trainer()
            trainer.restore()

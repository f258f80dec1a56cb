"""Optimizers over trees of tensors (port of ``repro/train/optimizer.py``):
AdamW, SGD-momentum and Lion, the warmup + cosine schedule, global-norm
clipping.

Params, gradients and the optimizer state are trees (dicts, lists and
tuples) of tensors, so :class:`~repro_torch.train.checkpoint.Checkpointer`
saves the state as it is.  :func:`apply_updates` runs under
``torch.no_grad()`` and returns new tensors, as the reference returns new
arrays.  The step count, the schedule and the bias corrections ``b ** t``
are float32 tensors on the params' device, computed op for op as the
reference computes them (a Python float64 ``lr`` would drift by ulps).
``torch.optim.AdamW`` is not used: its update order differs from the
reference's ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"           # adamw | sgd | lion
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """Leaves in the reference's order (``jax.tree.leaves``: dict keys
    sorted, list and tuple entries by index)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """The tree of ``template``'s structure (its dicts' key order kept)
    holding ``leaves``, given in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


# ---------------------------------------------------------------------------
# Schedule, norms, state
# ---------------------------------------------------------------------------

def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_opt_state(params, cfg: OptConfig) -> dict:
    """``step`` (an int32 0-d tensor on the params' device) and the
    moments, zeros shaped like the params: ``m`` and ``v`` for AdamW,
    ``m`` for SGD and Lion."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda: tree_map(  # noqa: E731
        lambda p: torch.zeros_like(p, requires_grad=False), params)
    st = dict(step=torch.zeros((), dtype=torch.int32, device=device))
    if cfg.kind == "adamw":
        st["m"] = zeros()
        st["v"] = zeros()
    elif cfg.kind in ("sgd", "lion"):
        st["m"] = zeros()
    return st


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's float32 sum of squares."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale, grads), g


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: OptConfig):
    """One optimizer step -> ``(new_params, new_state, {"lr",
    "grad_norm"})``; new tensors, none requiring grad."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)

    if cfg.kind == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g),
                     state["v"], grads)
        t = step.to(torch.float32)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
            return p - lr * (u + cfg.weight_decay * p)

        new_params = tree_map(upd, params, m, v)
        new_state = dict(step=step, m=m, v=v)
    elif cfg.kind == "lion":
        b1, b2 = cfg.b1, cfg.b2

        def upd(p, m_, g):
            u = torch.sign(b1 * m_ + (1 - b1) * g)
            return p - lr * (u + cfg.weight_decay * p)

        new_params = tree_map(upd, params, state["m"], grads)
        m = tree_map(lambda m_, g: b2 * m_ + (1 - b2) * g, state["m"], grads)
        new_state = dict(step=step, m=m)
    elif cfg.kind == "sgd":
        m = tree_map(lambda m_, g: cfg.b1 * m_ + g, state["m"], grads)
        new_params = tree_map(lambda p, m_: p - lr * m_, params, m)
        new_state = dict(step=step, m=m)
    else:
        raise ValueError(cfg.kind)
    return new_params, new_state, dict(lr=lr, grad_norm=gnorm)


def opt_state_axes(param_axes, cfg: OptConfig) -> dict:
    """Logical axes of the optimizer state (mirrors :func:`init_opt_state`):
    the moments share the params' axes, the step has none."""
    ax: dict = dict(step=())
    if cfg.kind == "adamw":
        ax["m"] = param_axes
        ax["v"] = param_axes
    elif cfg.kind in ("sgd", "lion"):
        ax["m"] = param_axes
    return ax

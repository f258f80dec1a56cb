"""Step builders and abstract inputs (port of ``repro/launch/steps.py``).

``make_*_step`` return the functions a driver calls for each step kind;
``abstract_params`` / ``abstract_opt`` / ``abstract_cache`` /
``batch_specs`` give the trees' shapes and dtypes as tensors on the meta
device (no allocation).  :func:`build_cell` assembles one (arch x shape x
mesh) cell for ``launch.dryrun``: the step, its abstract arguments, their
DTensor placements on the mesh (``distributed.sharding``) and the
arguments a step donates; with no mesh, a one-device cell (no
placements) that a caller can also materialize and run on a device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell, ShardPlan
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import trainable, value_and_grad

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Abstract params / optimizer / cache / batch
# ---------------------------------------------------------------------------

def abstract_params(cfg: ArchConfig, plan: ShardPlan) -> tuple:
    """``(params, axes)``: the LM's param tree as meta tensors and its
    logical axes."""
    return (T.init_lm(None, cfg, plan, device=META),
            T.lm_param_axes(cfg, plan))


def abstract_opt(params, opt_cfg: opt.OptConfig, param_axes) -> tuple:
    """``(state, axes)``: the optimizer state of ``params`` as meta
    tensors and its logical axes."""
    return (opt.init_opt_state(params, opt_cfg),
            opt.opt_state_axes(param_axes, opt_cfg))


def abstract_cache(cfg: ArchConfig, plan: ShardPlan, batch: int,
                   max_len: int) -> tuple:
    """``(cache, axes)``: the decode cache as meta tensors and its
    logical axes."""
    return (T.init_cache(cfg, plan, batch, max_len, dtype=cfg.compute_dtype,
                         device=META), T.cache_axes(cfg, plan))


def batch_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """The training or prefill batch of this arch's modality, as meta
    tensors: tokens (or frame features), patch embeddings for a VLM, and
    labels for a training cell."""
    B, L = cell.global_batch, cell.seq_len
    b: dict[str, Any] = {}
    if cfg.frame_input:
        b["frame_feats"] = _meta((B, L, cfg.frame_dim), torch.float32)
    else:
        b["tokens"] = _meta((B, L), torch.int32)
    if cfg.n_patches:
        b["patch_embeds"] = _meta((B, cfg.n_patches, cfg.vit_dim),
                                  torch.float32)
    if cell.kind == "train":
        b["labels"] = _meta((B, L), torch.int32)
    return b


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _at_use(params, mesh):
    """On a mesh, the params as a step computes with them
    (``sharding.at_use``: the FSDP data split gathered); else as they
    are."""
    return params if mesh is None else shd.at_use(params, mesh)


def make_train_step(cfg: ArchConfig, plan: ShardPlan,
                    opt_cfg: opt.OptConfig, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the LM loss, its gradient, one optimizer update.  On a
    ``mesh`` (DTensor params) the params are gathered over the data axes
    at use, as ``Trainer(mesh=)`` does (``sharding.at_use``)."""
    def loss(p, b):
        return T.lm_loss(_at_use(p, mesh), b, cfg, plan)

    def train_step(params, opt_state, batch):
        _, metrics, grads = value_and_grad(loss, params, batch)
        params, opt_state, stats = opt.apply_updates(params, grads,
                                                     opt_state, opt_cfg)
        return params, opt_state, {**metrics, **stats}

    return train_step


def make_prefill_step(cfg: ArchConfig, plan: ShardPlan, qmode: str = "train",
                      mesh=None):
    """``step(params, batch) -> (last-position logits, cache)``; for an
    encoder (no KV cache) the train-mode forward and an empty dict.  On a
    ``mesh`` the params are gathered over the data axes at use."""
    if not cfg.causal:
        def encode_step(params, batch):
            params = _at_use(params, mesh)
            with torch.no_grad():
                logits, _ = T.forward(
                    params, cfg, plan, tokens=batch.get("tokens"),
                    frame_feats=batch.get("frame_feats"), mode="train",
                    qmode=qmode)
            return logits[:, -1, :], {}

        return encode_step

    def prefill_step(params, batch):
        params = _at_use(params, mesh)
        with torch.no_grad():
            logits, cache = T.prefill(
                params, cfg, plan, tokens=batch.get("tokens"),
                patch_embeds=batch.get("patch_embeds"),
                frame_feats=batch.get("frame_feats"), qmode=qmode)
        return logits[:, -1, :], cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, plan: ShardPlan, qmode: str = "train",
                     mesh=None):
    """``step(params, cache, token, pos) -> (logits, cache)``; the cache
    is written in place.  On a ``mesh`` the params are gathered over the
    data axes at use."""
    def decode_step(params, cache, token, pos):
        params = _at_use(params, mesh)
        with torch.no_grad():
            logits, cache = T.decode_step(params, cache, token, pos, cfg,
                                          plan, qmode=qmode)
        return logits[:, -1, :], cache

    return decode_step


# ---------------------------------------------------------------------------
# Full cell assembly: (step_fn, abstract args, in/out shardings, donate)
# ---------------------------------------------------------------------------

def build_cell(cfg: ArchConfig, cell: ShapeCell, plan: ShardPlan, mesh,
               opt_cfg: opt.OptConfig | None = None, qmode: str = "train",
               prequant: bool = False) -> dict:
    """Everything ``launch.dryrun`` needs to run one (arch x shape x mesh)
    cell: ``fn``, ``args`` (meta tensors at the cell's global shapes; the
    params of a train cell require grad), ``in_shardings`` and
    ``out_shardings`` (trees of DTensor placement tuples on ``mesh``, as
    ``sharding.tree_shardings`` and ``batch_shardings`` give them; a
    decode cell's ``pos`` is a Python int, its entry replicated) and
    ``donate_argnums`` (the reference's: a step overwrites the params and
    optimizer state, a decode step its cache).  ``prequant`` serves a
    prefill or decode cell on prequantized params.  With ``mesh=None`` the
    shardings are None: a one-device cell."""
    opt_cfg = opt_cfg or opt.OptConfig()
    params, p_axes = abstract_params(cfg, plan)
    if prequant and cell.kind != "train":
        from repro_torch.models.layers import (prequantize_axes,
                                               prequantize_params)
        params = prequantize_params(params, cfg)
        p_axes = prequantize_axes(p_axes, cfg)

    def place(tree, axes):
        return (None if mesh is None
                else shd.tree_shardings(tree, axes, plan, mesh, cfg))

    def batch_place(tree):
        return (None if mesh is None
                else shd.batch_shardings(tree, plan, mesh))

    rep = None if mesh is None else shd.replicated(mesh)
    p_sh = place(params, p_axes)

    if cell.kind == "train":
        params = trainable(params)
        ostate, o_axes = abstract_opt(params, opt_cfg, p_axes)
        o_sh = place(ostate, o_axes)
        batch = batch_specs(cfg, cell)
        metrics = ("loss", "aux", "acc", "lr", "grad_norm")
        return dict(
            fn=make_train_step(cfg, plan, opt_cfg, mesh),
            args=(params, ostate, batch),
            in_shardings=(p_sh, o_sh, batch_place(batch)),
            out_shardings=(p_sh, o_sh, {k: rep for k in metrics}),
            donate_argnums=(0, 1))

    if cell.kind == "prefill":
        batch = batch_specs(cfg, cell)
        # the cache a prefill emits is shaped like its outputs (S slots);
        # it is placed like the decode cache
        B, S = cell.global_batch, cell.seq_len + cfg.n_patches
        cache, c_axes = abstract_cache(cfg, plan, B, S)
        logits = _meta((B, cfg.padded_vocab), torch.float32)
        out_sh = (batch_place(logits),
                  place(cache, _match_cache_axes(cache, c_axes))
                  if cfg.causal else {})
        return dict(fn=make_prefill_step(cfg, plan, qmode, mesh),
                    args=(params, batch),
                    in_shardings=(p_sh, batch_place(batch)),
                    out_shardings=out_sh, donate_argnums=())

    B = cell.global_batch
    cache, c_axes = abstract_cache(cfg, plan, B, cell.seq_len)
    c_sh = place(cache, _match_cache_axes(cache, c_axes))
    token = _meta((B, 1), torch.int32)
    logits = _meta((B, cfg.padded_vocab), torch.float32)
    return dict(
        fn=make_decode_step(cfg, plan, qmode, mesh),
        args=(params, cache, token, cell.seq_len - 1),
        in_shardings=(p_sh, c_sh, batch_place(token), rep),
        out_shardings=(batch_place(logits), c_sh),
        donate_argnums=(1,))


def _match_cache_axes(cache_tree, cache_axes):
    """The axes tree pruned to the kinds present in the cache tree."""
    return {k: cache_axes[k] for k in cache_tree}

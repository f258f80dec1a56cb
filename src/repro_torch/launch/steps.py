"""Step builders and abstract inputs (port of ``repro/launch/steps.py``).

``make_*_step`` return the functions a driver calls for each step kind;
``abstract_params`` / ``abstract_opt`` / ``abstract_cache`` /
``batch_specs`` give the trees' shapes and dtypes as tensors on the meta
device (no allocation).  ``build_cell``'s shardings come with the
distributed slice: this port runs on one device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell, ShardPlan
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import value_and_grad

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Abstract params / optimizer / cache / batch
# ---------------------------------------------------------------------------

def abstract_params(cfg: ArchConfig, plan: ShardPlan) -> dict:
    """The LM's param tree as meta tensors."""
    return T.init_lm(None, cfg, plan, device=META)


def abstract_opt(params, opt_cfg: opt.OptConfig) -> dict:
    """The optimizer state of ``params`` as meta tensors."""
    return opt.init_opt_state(params, opt_cfg)


def abstract_cache(cfg: ArchConfig, plan: ShardPlan, batch: int,
                   max_len: int) -> dict:
    return T.init_cache(cfg, plan, batch, max_len, dtype=cfg.compute_dtype,
                        device=META)


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

def make_train_step(cfg: ArchConfig, plan: ShardPlan,
                    opt_cfg: opt.OptConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the LM loss, its gradient, one optimizer update."""
    def train_step(params, opt_state, batch):
        _, metrics, grads = value_and_grad(
            lambda p, b: T.lm_loss(p, b, cfg, plan), params, batch)
        params, opt_state, stats = opt.apply_updates(params, grads,
                                                     opt_state, opt_cfg)
        return params, opt_state, {**metrics, **stats}

    return train_step


def make_prefill_step(cfg: ArchConfig, plan: ShardPlan, qmode: str = "train"):
    """``step(params, batch) -> (last-position logits, cache)``; for an
    encoder (no KV cache) the train-mode forward and an empty dict."""
    if not cfg.causal:
        def encode_step(params, batch):
            with torch.no_grad():
                logits, _ = T.forward(
                    params, cfg, plan, tokens=batch.get("tokens"),
                    frame_feats=batch.get("frame_feats"), mode="train",
                    qmode=qmode)
            return logits[:, -1, :], {}

        return encode_step

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, cache = T.prefill(
                params, cfg, plan, tokens=batch.get("tokens"),
                patch_embeds=batch.get("patch_embeds"),
                frame_feats=batch.get("frame_feats"), qmode=qmode)
        return logits[:, -1, :], cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, plan: ShardPlan, qmode: str = "train"):
    """``step(params, cache, token, pos) -> (logits, cache)``; the cache
    is written in place."""
    def decode_step(params, cache, token, pos):
        with torch.no_grad():
            logits, cache = T.decode_step(params, cache, token, pos, cfg,
                                          plan, qmode=qmode)
        return logits[:, -1, :], cache

    return decode_step

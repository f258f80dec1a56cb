"""The dense LM of the serve path (port of the dense family of
``repro/models/transformer.py``).

A model is the ``('attn',)`` block pattern tiled over ``n_layers``:
attention + MLP per layer.  Params keep the reference's layout — one
stacked tree per block kind, leading axis the layer — and the layer stack
is a plain Python loop over per-layer views (:func:`unstack_layers`),
where the reference scans superblocks.  Entry points compute the views
once and pass them as ``layers``.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from .layers import (attention_fwd, mlp_fwd, paged_rows, qdense, rms_norm,
                     rope_tables)


def _dense(gen, shape, fan_in: int, device, scale: float | None = None):
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, device=device) * s


def init_lm(gen: torch.Generator, cfg, plan, device=None) -> dict:
    """Random params in the reference's layout: N(0, 1/fan_in) projection
    weights stacked per layer, unit norm scales, the embedding x0.02, all
    float32, drawn from ``gen`` on ``device`` (default: the generator's)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not yet ported")
    device = device or gen.device
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    hp, hkv, ff = plan.padded_heads(cfg.n_heads), cfg.n_kv_heads, cfg.d_ff
    ones = lambda *s: torch.ones(s, device=device)  # noqa: E731
    attn = {"ln": ones(L, d),
            "wq": _dense(gen, (L, d, hp * hd), d, device),
            "wk": _dense(gen, (L, d, hkv * hd), d, device),
            "wv": _dense(gen, (L, d, hkv * hd), d, device),
            "wo": _dense(gen, (L, hp * hd, d), hp * hd, device)}
    if cfg.qk_norm:
        attn["q_norm"], attn["k_norm"] = ones(L, hd), ones(L, hd)
    mlp = {"ln": ones(L, d), "w_in": _dense(gen, (L, d, ff), d, device)}
    if cfg.act == "swiglu":
        mlp["w_gate"] = _dense(gen, (L, d, ff), d, device)
    mlp["w_out"] = _dense(gen, (L, ff, d), ff, device)
    params: dict[str, Any] = {
        "embed": torch.randn((cfg.padded_vocab, d), generator=gen,
                             device=device) * 0.02,
        "final_norm": ones(d),
        "blocks": {"attn": {"attn": attn, "mlp": mlp}},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(gen, (d, cfg.padded_vocab), d, device,
                                   scale=0.02)
    return params


def _check_pattern(cfg) -> None:
    bad = sorted({k for k in cfg.blocks_pattern if k != "attn"})
    if bad:
        raise NotImplementedError(f"block kinds {bad} are not yet ported "
                                  f"(ported: 'attn')")


def init_cache(cfg, plan, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Contiguous decode cache: stacked k/v (L, B, slots, Hkv, hd) and
    pos (L, B, slots), -1 = empty."""
    _check_pattern(cfg)
    dtype = dtype or cfg.compute_dtype
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    slots = min(cfg.window, max_len) if cfg.window else max_len
    return {"attn": dict(
        k=torch.zeros((L, batch, slots, hkv, hd), dtype=dtype, device=device),
        v=torch.zeros((L, batch, slots, hkv, hd), dtype=dtype, device=device),
        pos=torch.full((L, batch, slots), -1, dtype=torch.int32,
                       device=device))}


def init_paged_cache(cfg, plan, num_slots: int, num_pages: int,
                     page_size: int, table_pages: int, dtype=None,
                     device=None) -> dict:
    """Paged decode cache: pools pk/pv (L, NP+1, ps, Hkv, hd) — NP pages
    plus the reserved null page (index NP, never written) — positions ppos
    (L, NP+1, ps) = -1, and the page table (num_slots, table_pages) = the
    null page.  One table serves every layer (the reference replicates it
    per layer to keep its scanned cache uniform)."""
    _check_pattern(cfg)
    dtype = dtype or cfg.compute_dtype
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    shape = (L, num_pages + 1, page_size, hkv, hd)
    return {"attn": dict(
        pk=torch.zeros(shape, dtype=dtype, device=device),
        pv=torch.zeros(shape, dtype=dtype, device=device),
        ppos=torch.full((L, num_pages + 1, page_size), -1, dtype=torch.int32,
                        device=device),
        table=torch.full((num_slots, table_pages), num_pages,
                         dtype=torch.int32, device=device))}


def _slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_layers(params, cfg) -> list:
    """Per-layer views of the stacked block params, in layer order."""
    _check_pattern(cfg)
    tree = params["blocks"]["attn"]
    return [_slice(tree, i) for i in range(cfg.n_layers)]


def run_blocks(params, h, cfg, plan, *, mode: str, pos_offset=0, cache=None,
               qmode: str = "serve", valid_len=None, layers=None,
               reference: bool = False):
    """The layer stack as a Python loop.  Returns ``(h, new_cache)``:
    prefill returns the stacked new cache, decode and paged steps the
    cache they updated in place."""
    layers = layers if layers is not None else unstack_layers(params, cfg)
    c = cache["attn"] if cache is not None else None
    S = h.shape[1]
    rows = None
    if mode == "paged":
        np1, ps = c["ppos"].shape[1:]
        rows = paged_rows(c["table"], pos_offset, valid_len, S, ps, np1 - 1)
        positions = rows["q_pos"]
    else:
        positions = pos_offset + torch.arange(S, device=h.device)
    rope_cs = rope_tables(positions, cfg.hd, cfg.rope_theta)
    new_k, new_v, new_pos = [], [], []
    for i, p in enumerate(layers):
        if mode == "paged":
            att, _ = attention_fwd(
                p["attn"], h, cfg, plan, mode="paged", pos_offset=pos_offset,
                cache_k=c["pk"][i], cache_v=c["pv"][i], cache_pos=c["ppos"][i],
                cache_table=c["table"], valid_len=valid_len, qmode=qmode,
                reference=reference, rope_cs=rope_cs, rows=rows)
        elif mode == "decode":
            att, _ = attention_fwd(
                p["attn"], h, cfg, plan, mode="decode", pos_offset=pos_offset,
                cache_k=c["k"][i], cache_v=c["v"][i], cache_pos=c["pos"][i],
                qmode=qmode, reference=reference, rope_cs=rope_cs)
        else:
            att, (nk, nv, npos) = attention_fwd(
                p["attn"], h, cfg, plan, mode=mode, pos_offset=pos_offset,
                qmode=qmode, reference=reference, rope_cs=rope_cs)
            new_k.append(nk)
            new_v.append(nv)
            new_pos.append(npos)
        h = h + att
        h = h + mlp_fwd(p["mlp"], h, cfg)
    if mode == "prefill":
        return h, {"attn": dict(k=torch.stack(new_k), v=torch.stack(new_v),
                                pos=torch.stack(new_pos))}
    return h, cache


def embed_inputs(params, cfg, tokens) -> torch.Tensor:
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


def unembed(params, cfg, h) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"])
    if cfg.tie_embeddings:
        logits = h @ params["embed"].t().to(h.dtype)
    else:
        logits = qdense(h, params["lm_head"], cfg.quant, role="last")
    return logits.float()


def forward(params, cfg, plan, *, tokens, mode: str = "prefill", cache=None,
            pos_offset=0, qmode: str = "serve", valid_len=None, layers=None,
            reference: bool = False):
    """Full forward -> ``(logits float32 (B, S, padded_vocab), cache)``."""
    h = embed_inputs(params, cfg, tokens)
    h, new_cache = run_blocks(params, h, cfg, plan, mode=mode,
                              pos_offset=pos_offset, cache=cache, qmode=qmode,
                              valid_len=valid_len, layers=layers,
                              reference=reference)
    return unembed(params, cfg, h), new_cache


def prefill(params, cfg, plan, *, tokens, qmode: str = "serve", layers=None,
            reference: bool = False):
    return forward(params, cfg, plan, tokens=tokens, mode="prefill",
                   qmode=qmode, layers=layers, reference=reference)


def decode_step(params, cache, token, pos: int, cfg, plan,
                qmode: str = "serve", layers=None, reference: bool = False):
    """One token step: token (B, 1), ``pos`` a Python int.  Writes the
    cache in place -> ``(logits, cache)``."""
    return forward(params, cfg, plan, tokens=token, mode="decode",
                   cache=cache, pos_offset=pos, qmode=qmode, layers=layers,
                   reference=reference)


def paged_step(params, cache, tokens, pos, valid_len, cfg, plan,
               qmode: str = "serve", layers=None, reference: bool = False):
    """One paged step over the in-flight slot batch: tokens (B, S); pos and
    valid_len (B,) int tensors (valid_len 0 = slot idle).  The
    continuous engine calls it at (1, chunk) and (num_slots, 1).  Writes
    the pools in place -> ``(logits, cache)``."""
    return forward(params, cfg, plan, tokens=tokens, mode="paged",
                   cache=cache, pos_offset=pos, valid_len=valid_len,
                   qmode=qmode, layers=layers, reference=reference)

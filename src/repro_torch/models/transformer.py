"""The LM of the serve path (port of ``repro/models/transformer.py``): the
dense, MoE, recurrent, encoder and VLM families.

A model is a block pattern (``cfg.pattern``) tiled over ``n_layers``:
  dense    -> ('attn',)                  attention + MLP
  moe      -> ('moe',)                   attention + MoE FFN (+ shared)
  rwkv     -> ('rwkv',)                  RWKV-6 time mix + channel mix
  rglru    -> ('rec','rec','attn_local') RecurrentGemma 2:1 pattern
  encoder  -> ('attn',), non-causal, frame features projected in place
              of token embeddings (``frame_feats``; no ``embed``)
  vlm      -> ('attn',), patch embeddings projected and prepended to the
              text (``patch_embeds``); decode goes on at n_patches + S
Params keep the reference's layout — one stacked tree per block kind,
leading axis the layer within that kind (recurrentgemma's 38 layers are
26 'rec' and 12 'attn_local') — and the layer stack is a plain Python
loop over per-layer views in ``blocks_pattern`` order
(:func:`unstack_layers`, each view carrying its kind), where the
reference scans superblocks.  Entry points compute the views once and
pass them as ``layers``.  Caches hold one stacked entry per kind: k/v/pos
for the attention kinds (an 'attn_local' cache has ``min(window,
max_len)`` slots), float32 ``h``/``conv`` for 'rec', ``tm_x``/``cm_x``
(compute dtype) and float32 ``s`` for 'rwkv'.  Decode and paged steps
update the cache they are given in place, recurrent state included.

Train mode (``forward(mode="train")``, :func:`lm_loss`) runs the prefill
computation with no cache and no state returned, every projection the
fake-quant product with straight-through gradients, and sums the MoE
layers' load-balancing aux loss; ``cfg.remat`` recomputes each block in
the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` per period).  It launches no port kernel.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from . import rglru, rwkv6
from .layers import (attention_axes, attention_fwd, dense_init,
                     init_attention, init_mlp, init_moe, mlp_axes, mlp_fwd,
                     moe_axes, moe_fwd, paged_rows, qdense, rms_norm,
                     rope_tables)

ATTN_KINDS = ("attn", "moe", "attn_local")
BLOCK_KINDS = ATTN_KINDS + ("rec", "rwkv")
PORTED_FAMILIES = ("dense", "moe", "rwkv", "rglru", "encoder", "vlm")


def _init_kind(kind: str, gen, cfg, plan, n: int, device) -> dict:
    if kind in ("attn", "attn_local"):
        return {"attn": init_attention(gen, cfg, plan, n, device),
                "mlp": init_mlp(gen, cfg, n, device)}
    if kind == "moe":
        return {"attn": init_attention(gen, cfg, plan, n, device),
                "moe": init_moe(gen, cfg, plan, n, device)}
    if kind == "rec":
        return {"rec": rglru.init_rec_block(gen, cfg, plan, n, device),
                "mlp": init_mlp(gen, cfg, n, device)}
    if kind == "rwkv":
        return rwkv6.init_rwkv_block(gen, cfg, plan, n, device)
    raise ValueError(kind)


def init_lm(gen: torch.Generator, cfg, plan, device=None) -> dict:
    """Random params in the reference's layout: one stacked tree per block
    kind (kinds in order of first occurrence), N(0, 1/fan_in) projection
    weights, unit norm scales, the embedding x0.02 (``frame_proj`` in its
    place for frame input, and ``vision_proj`` where the config has
    patches), all float32, drawn from ``gen`` on ``device`` (default: the
    generator's)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    device = device or gen.device
    d = cfg.d_model
    blocks = {kind: _init_kind(kind, gen, cfg, plan, cfg.n_blocks_of(kind),
                               device)
              for kind in dict.fromkeys(cfg.blocks_pattern)}
    params: dict[str, Any] = {}
    if cfg.frame_input:
        params["frame_proj"] = dense_init(gen, (cfg.frame_dim, d),
                                          cfg.frame_dim, device)
    else:
        params["embed"] = torch.randn((cfg.padded_vocab, d), generator=gen,
                                      device=device).mul_(0.02)
    if cfg.n_patches:
        params["vision_proj"] = dense_init(gen, (cfg.vit_dim, d),
                                           cfg.vit_dim, device)
    params["final_norm"] = torch.ones((d,), device=device)
    params["blocks"] = blocks
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.padded_vocab), d, device,
                                       scale=0.02)
    return params


def _kind_axes(kind: str, cfg) -> dict:
    if kind in ("attn", "attn_local"):
        return {"attn": attention_axes(cfg), "mlp": mlp_axes(cfg)}
    if kind == "moe":
        return {"attn": attention_axes(cfg), "moe": moe_axes(cfg)}
    if kind == "rec":
        return {"rec": rglru.rec_block_axes(cfg), "mlp": mlp_axes(cfg)}
    if kind == "rwkv":
        return rwkv6.rwkv_block_axes(cfg)
    raise ValueError(kind)


def _stack_axes(axes):
    """A leading ``"layers"`` on every leaf of a per-block axes tree."""
    if isinstance(axes, dict):
        return {k: _stack_axes(v) for k, v in axes.items()}
    return ("layers",) + tuple(axes or ())


def lm_param_axes(cfg, plan) -> dict:
    """The logical axes of :func:`init_lm`'s params, leaf for leaf: a
    tuple of names (``"embed"``, ``"heads"``, ``"vocab"``, ...) per
    tensor dim, the reference's ``init_lm`` axes tree.  ``plan`` is taken
    as the reference's is (its head padding shapes ``wq``/``wo``, not
    their axes)."""
    del plan
    axes: dict[str, Any] = {}
    if cfg.frame_input:
        axes["frame_proj"] = (None, "embed")
    else:
        axes["embed"] = ("vocab_in", "embed")
    if cfg.n_patches:
        axes["vision_proj"] = (None, "embed")
    axes["final_norm"] = ("embed",)
    axes["blocks"] = {kind: _stack_axes(_kind_axes(kind, cfg))
                      for kind in dict.fromkeys(cfg.blocks_pattern)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def _kind_counts(cfg) -> dict:
    counts: dict[str, int] = {}
    for kind in cfg.blocks_pattern:
        counts[kind] = counts.get(kind, 0) + 1
    return counts


def init_cache(cfg, plan, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Decode cache, one stacked entry per block kind: k/v (n, B, slots,
    Hkv, hd) and pos (n, B, slots) = -1 for the attention kinds ('attn_local'
    keeps ``min(window, max_len)`` slots), float32 h (n, B, W) and conv
    (n, B, cw-1, W) for 'rec', tm_x/cm_x (n, B, d) in ``dtype`` and float32
    s (n, B, H, K, K) for 'rwkv'."""
    dtype = dtype or cfg.compute_dtype
    d, hkv, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
    f32 = torch.float32
    cache = {}
    for kind, n in _kind_counts(cfg).items():
        if kind in ATTN_KINDS:
            slots = (min(cfg.window, max_len)
                     if kind == "attn_local" and cfg.window else max_len)
            shape = (n, batch, slots, hkv, hd)
            cache[kind] = dict(
                k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device),
                pos=torch.full((n, batch, slots), -1, dtype=torch.int32,
                               device=device))
        elif kind == "rec":
            W = cfg.lru_width or d
            cache[kind] = dict(
                h=torch.zeros((n, batch, W), dtype=f32, device=device),
                conv=torch.zeros((n, batch, cfg.conv_width - 1, W),
                                 dtype=f32, device=device))
        elif kind == "rwkv":
            K = cfg.rwkv_head_dim
            cache[kind] = dict(
                tm_x=torch.zeros((n, batch, d), dtype=dtype, device=device),
                cm_x=torch.zeros((n, batch, d), dtype=dtype, device=device),
                s=torch.zeros((n, batch, d // K, K, K), dtype=f32,
                              device=device))
        else:
            raise ValueError(kind)
    return cache


def cache_axes(cfg, plan) -> dict:
    """The logical axes of :func:`init_cache`'s tree, leaf for leaf (the
    reference's ``cache_axes``)."""
    del plan
    ax: dict[str, Any] = {}
    for kind in _kind_counts(cfg):
        if kind in ATTN_KINDS:
            kv = ("layers", "batch", "cache_seq", "kv_heads", None)
            ax[kind] = dict(k=kv, v=kv, pos=("layers", "batch", "cache_seq"))
        elif kind == "rec":
            ax[kind] = dict(h=("layers", "batch", "mlp"),
                            conv=("layers", "batch", None, "mlp"))
        elif kind == "rwkv":
            ax[kind] = dict(tm_x=("layers", "batch", "embed"),
                            cm_x=("layers", "batch", "embed"),
                            s=("layers", "batch", "heads", None, None))
    return ax


def init_paged_cache(cfg, plan, num_slots: int, num_pages: int,
                     page_size: int, table_pages: int, dtype=None,
                     device=None) -> dict:
    """Paged decode cache: pools pk/pv (L, NP+1, ps, Hkv, hd) — NP pages
    plus the reserved null page (index NP, never written) — positions ppos
    (L, NP+1, ps) = -1, and the page table (num_slots, table_pages) = the
    null page.  One table serves every layer (the reference replicates it
    per layer to keep its scanned cache uniform).

    Only the pure-attention pattern is served, as in the reference:
    recurrent and RWKV state is not page-granular, rolling-window layers
    would need a second allocator policy, and the reference refuses the
    MoE pattern too."""
    bad = [k for k in set(cfg.blocks_pattern) if k != "attn"]
    if bad:
        raise ValueError(
            f"paged KV cache requires a pure-'attn' block pattern; "
            f"got kinds {sorted(bad)}")
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


def _unbind(tree):
    """Each stacked leaf split along its layer axis once (one backward
    node a leaf, where indexing it per layer would make one each)."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return torch.unbind(tree)


def _slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


class LayerView(dict):
    """One layer's params (the stacked tree sliced at the layer), carrying
    its block ``kind`` and its ``index`` among that kind's stacked params
    and caches."""

    def __init__(self, kind: str, index: int, params: dict):
        super().__init__(params)
        self.kind, self.index = kind, index


def unstack_layers(params, cfg) -> list:
    """Per-layer views of the stacked block params, in ``blocks_pattern``
    order (the counterpart of the reference's per-kind slicing)."""
    bad = sorted(set(cfg.blocks_pattern) - set(BLOCK_KINDS))
    if bad:
        raise NotImplementedError(f"block kinds {bad} are not ported")
    seen: dict[str, int] = {}
    split = {kind: _unbind(tree) for kind, tree in params["blocks"].items()}
    views = []
    for kind in cfg.blocks_pattern:
        i = seen.get(kind, 0)
        seen[kind] = i + 1
        views.append(LayerView(kind, i, _slice(split[kind], i)))
    return views


def _train_block(p, h, cfg, plan, qmode: str, rope_cs):
    """One layer of the training forward -> ``(h, aux)``."""
    kind = p.kind
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind in ATTN_KINDS:
        window = cfg.window if kind == "attn_local" else None
        att, _ = attention_fwd(p["attn"], h, cfg, plan, mode="train",
                               qmode=qmode, window=window, rope_cs=rope_cs)
        h = _constrain_batch(h + att, cfg, plan)
        if kind == "moe":
            y, aux = moe_fwd(p["moe"], h, cfg)
            return h + y, aux
        return h + mlp_fwd(p["mlp"], h, cfg, qmode=qmode), aux
    if kind == "rec":
        out, _ = rglru.rec_block_fwd(p["rec"], h, cfg, plan, mode="train")
        h = _constrain_batch(h + out, cfg, plan)
        return h + mlp_fwd(p["mlp"], h, cfg, qmode=qmode), aux
    h, _ = rwkv6.rwkv_block_fwd(p, h, cfg, plan, mode="train")
    return h, aux


def _run_blocks_train(h, cfg, plan, layers, qmode: str):
    """The training layer stack -> ``(h, aux summed over layers)``; with
    ``cfg.remat`` each block is recomputed in the backward."""
    S = h.shape[1]
    rope_cs = None
    if any(lv.kind in ATTN_KINDS for lv in layers):
        rope_cs = rope_tables(torch.arange(S, device=h.device), cfg.hd,
                              cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p in layers:
        if cfg.remat and torch.is_grad_enabled():
            h, a = checkpoint(_train_block, p, h, cfg, plan, qmode, rope_cs,
                              use_reentrant=False)
        else:
            h, a = _train_block(p, h, cfg, plan, qmode, rope_cs)
        h = _constrain_batch(h, cfg, plan)
        aux = aux + a
    return h, aux


def _constrain_batch(h, cfg, plan):
    """With ``cfg.constrain_acts``, the residual stream on a mesh (a
    DTensor) redistributed to split over the plan's batch axes and
    replicated over the rest (the reference's sharding constraint: it
    makes the FSDP weights gather rather than the activations
    replicate).  Applied after the embedding and each block, as in the
    reference, and after each residual add inside a block: left to
    itself, DTensor resolves a row-parallel projection's partial sums by
    splitting the sequence, and on the 2 x 16 x 16 mesh its planner then
    takes minutes for one product.  Unchanged without a mesh, without
    batch axes, or where the batch does not divide by ``plan.dp``, as in
    the reference."""
    if not cfg.constrain_acts:
        return h
    from torch.distributed.tensor import DTensor

    if (not isinstance(h, DTensor) or not plan.batch_axes
            or h.shape[0] % plan.dp):
        return h
    from repro_torch.distributed.sharding import batch_pspec, placements_for

    pl = placements_for(batch_pspec(plan, h.ndim), h.device_mesh)
    return h if tuple(h.placements) == pl else h.redistribute(
        h.device_mesh, pl)


def run_blocks(params, h, cfg, plan, *, mode: str, pos_offset=0, cache=None,
               qmode: str = "serve", valid_len=None, layers=None,
               reference: bool = False):
    """The layer stack as a Python loop, dispatching on each layer's kind
    as the reference's ``_run_block`` does.  Returns ``(h, new_cache)``:
    prefill returns the stacked new cache, decode and paged steps the
    cache they updated in place; train mode returns ``(h, aux)``, the
    summed aux loss in place of a cache."""
    layers = layers if layers is not None else unstack_layers(params, cfg)
    if mode == "train":
        if cache is not None:
            raise ValueError("train mode runs without a cache")
        return _run_blocks_train(h, cfg, plan, layers, qmode)
    S = h.shape[1]
    rows = rope_cs = None
    if any(lv.kind in ATTN_KINDS for lv in layers):
        if mode == "paged":
            c = cache["attn"]
            np1, ps = c["ppos"].shape[1:]
            rows = paged_rows(c["table"], pos_offset, valid_len, S, ps,
                              np1 - 1)
            positions = rows["q_pos"]
        else:
            positions = pos_offset + torch.arange(S, device=h.device)
        rope_cs = rope_tables(positions, cfg.hd, cfg.rope_theta)
    new: dict[str, list] = {}
    for p in layers:
        kind, i = p.kind, p.index
        c = cache[kind] if cache is not None else None
        if kind in ATTN_KINDS:
            window = cfg.window if kind == "attn_local" else None
            kw = dict(mode=mode, pos_offset=pos_offset, qmode=qmode,
                      window=window, reference=reference, rope_cs=rope_cs)
            if mode == "paged":
                att, _ = attention_fwd(
                    p["attn"], h, cfg, plan, cache_k=c["pk"][i],
                    cache_v=c["pv"][i], cache_pos=c["ppos"][i],
                    cache_table=c["table"], valid_len=valid_len, rows=rows,
                    **kw)
            elif mode == "decode":
                att, _ = attention_fwd(
                    p["attn"], h, cfg, plan, cache_k=c["k"][i],
                    cache_v=c["v"][i], cache_pos=c["pos"][i], **kw)
            else:
                att, (nk, nv, npos) = attention_fwd(p["attn"], h, cfg, plan,
                                                    **kw)
                new.setdefault(kind, []).append(dict(k=nk, v=nv, pos=npos))
            h = _constrain_batch(h + att, cfg, plan)
            if kind == "moe":
                h = h + moe_fwd(p["moe"], h, cfg)[0]
            else:
                h = h + mlp_fwd(p["mlp"], h, cfg, qmode=qmode)
            h = _constrain_batch(h, cfg, plan)
            continue
        state = ({k: v[i] for k, v in c.items()} if c is not None else None)
        if kind == "rec":
            out, st = rglru.rec_block_fwd(p["rec"], h, cfg, plan, mode=mode,
                                          state=state)
            h = _constrain_batch(h + out, cfg, plan)
            h = h + mlp_fwd(p["mlp"], h, cfg, qmode=qmode)
        else:
            h, st = rwkv6.rwkv_block_fwd(p, h, cfg, plan, mode=mode,
                                         state=state)
        h = _constrain_batch(h, cfg, plan)
        if c is not None:                 # decode: the state in place
            for k, v in st.items():
                c[k][i].copy_(v)
        else:
            new.setdefault(kind, []).append(st)
    if mode == "prefill":
        return h, {kind: {k: torch.stack([e[k] for e in entries])
                          for k in entries[0]}
                   for kind, entries in new.items()}
    return h, cache


def embed_inputs(params, cfg, tokens=None, patch_embeds=None,
                 frame_feats=None) -> torch.Tensor:
    """The input sequence in the compute dtype: token embeddings, or for
    frame input ``frame_feats @ frame_proj`` (the features in their own
    dtype against the projection in the compute dtype, promoted as the
    reference's matmul promotes); with patches, ``patch_embeds @
    vision_proj`` in the compute dtype, prepended."""
    cd = cfg.compute_dtype
    if cfg.frame_input:
        if frame_feats is None:
            raise ValueError(
                f"{cfg.name} takes frame features, not tokens: call "
                f"prefill(frame_feats=(B, T, {cfg.frame_dim}))")
        w = params["frame_proj"].to(cd)
        ct = torch.promote_types(frame_feats.dtype, cd)
        h = (frame_feats.to(ct) @ w.to(ct)).to(cd)
    else:
        # the embedding op, not an index: the same gather, and its
        # backward is the one DTensor splits over a batch-split token
        # tensor on every torch (index_put's fails on 2.11)
        h = torch.nn.functional.embedding(tokens.long(),
                                          params["embed"]).to(cd)
    if cfg.n_patches and patch_embeds is not None:
        vis = patch_embeds.to(cd) @ params["vision_proj"].to(cd)
        h = torch.cat([vis, h], dim=1)
    return h


def unembed(params, cfg, h) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"])
    if cfg.tie_embeddings:
        logits = h @ params["embed"].t().to(h.dtype)
    else:
        logits = qdense(h, params["lm_head"], cfg.quant, role="last")
    return logits.float()


def forward(params, cfg, plan, *, tokens=None, patch_embeds=None,
            frame_feats=None, mode: str = "prefill", cache=None,
            pos_offset=0, qmode: str = "serve", valid_len=None, layers=None,
            reference: bool = False):
    """Full forward -> ``(logits float32 (B, S, padded_vocab), cache)``;
    S counts the prepended patches.  In ``mode="train"`` the second
    element is the summed aux loss (there is no cache)."""
    h = _constrain_batch(
        embed_inputs(params, cfg, tokens, patch_embeds, frame_feats), cfg,
        plan)
    h, new_cache = run_blocks(params, h, cfg, plan, mode=mode,
                              pos_offset=pos_offset, cache=cache, qmode=qmode,
                              valid_len=valid_len, layers=layers,
                              reference=reference)
    return unembed(params, cfg, h), new_cache


def lm_loss(params, batch: dict, cfg, plan, qmode: str = "train"):
    """Next-token (or frame-classification) cross-entropy of the training
    forward -> ``(loss + aux, {"loss", "aux", "acc"})``.  ``batch`` holds
    ``labels`` (B, S) and ``tokens``, ``frame_feats`` and/or
    ``patch_embeds`` per family; a VLM's loss covers its text positions
    only.  The vocab padding is masked at -1e30; labels outside
    [0, vocab) are left out of the loss and the accuracy.  The label's
    log-probability is picked by a gather, equal to the reference's
    one-hot contraction exactly (one nonzero term)."""
    logits, aux = forward(params, cfg, plan, tokens=batch.get("tokens"),
                          patch_embeds=batch.get("patch_embeds"),
                          frame_feats=batch.get("frame_feats"),
                          mode="train", qmode=qmode)
    labels = batch["labels"].long()
    if cfg.n_patches:
        logits = logits[:, cfg.n_patches:]
    vp = logits.shape[-1]
    if vp > cfg.vocab:
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab
        logits = torch.where(pad[None, None], -1e30, logits)
    valid = (labels >= 0) & (labels < cfg.vocab)
    labels_c = torch.clamp(labels, 0, cfg.vocab - 1)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels_c[..., None])[..., 0]
    n = torch.clamp(valid.sum(), min=1)
    loss = -torch.where(valid, ll, 0.0).sum() / n
    acc = (valid & (torch.argmax(logits, -1) == labels_c)).sum() / n
    return loss + aux, dict(loss=loss, aux=aux, acc=acc)


def prefill(params, cfg, plan, *, tokens=None, patch_embeds=None,
            frame_feats=None, qmode: str = "serve", layers=None,
            reference: bool = False):
    return forward(params, cfg, plan, tokens=tokens,
                   patch_embeds=patch_embeds, frame_feats=frame_feats,
                   mode="prefill", qmode=qmode, layers=layers,
                   reference=reference)


def decode_step(params, cache, token, pos: int, cfg, plan,
                qmode: str = "serve", layers=None, reference: bool = False):
    """One token step: token (B, 1), ``pos`` a Python int (after a VLM
    prefill with patches, ``n_patches + S``).  Writes the cache in place
    -> ``(logits, cache)``."""
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

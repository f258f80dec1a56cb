"""Transformer layers of the LM serve path (port of ``repro/models/layers.py``).

Conventions follow the reference: activations ``(B, S, d)``, attention
heads ``(B, S, H, hd)``, params as nested dicts of tensors.  Every
projection is a :func:`qdense`: prequantized ``{"q", "s", "z"}`` weights
run the signed level GEMM; float weights are the train-mode fake-quant
product on quantized configs (the reference's serve path calls it for
the weights its one-level-deep prequantization leaves float: RG-LRU's
``wx``/``wy``, every RWKV-6 projection, the MoE's shared expert) and a
plain matmul on fp configs.

Attention engines: ``full`` (materialized logits), ``chunked`` (an
online-softmax scan over padded KV chunks) and ``banded`` (block-diagonal
window bands) in plain PyTorch — the reference computes them in XLA —
``flash`` (``kernels.attn_flash.attn_flash``, the CUDA kernel for
contiguous quantized prefill) and ``paged``
(``kernels.attn_flash.attn_paged``, the CUDA kernel for the page-table
cache).  ``reference=True`` runs the kernels' plain versions on any
device.  Caches are updated in place (decode writes one slot of the
contiguous cache; a paged step writes its valid rows into the pools),
where the reference returns new arrays: the port holds one copy of the KV
state.

The MoE FFN (:func:`moe_fwd`) is the reference's token-choice top-k with
capacity drops; its expert products are float einsums, as in the
reference (no Pallas kernel there, none here).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.and_accum import (SIGNED_ENGINES,
                                        quant_dense_forward_signed_pre)
from repro_torch.core.quant import (QuantConfig, fake_quant_act_signed,
                                    quantize_weight, weight_levels)

NEG_INF = -1e30
PREQUANT_KEYS = {"wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out"}


# ---------------------------------------------------------------------------
# Quantized dense
# ---------------------------------------------------------------------------

def qdense(x: torch.Tensor, w, quant: QuantConfig, *,
           role: str = "mid", mode: str = "train") -> torch.Tensor:
    """Dense layer.  ``w`` prequantized (``{"q": (K, N) int8 levels,
    "s": 0-d, "z": 0-d}``) runs the signed level GEMM with the config's
    activation-scale mode, whatever ``mode``.  A float ``w`` is a plain
    matmul on fp configs and on first/last layers kept fp; otherwise
    ``mode="train"`` is the fake-quant product (per-tensor signed
    activation levels times the DoReFa weight, both in their float
    straight-through form ``x + (q - x)``), and ``mode="serve"`` raises:
    the port serves prequantized weights only."""
    if isinstance(w, dict):
        a_scale = "row" if quant.act_scale_mode == "row" else None
        return quant_dense_forward_signed_pre(
            x, w["q"], w["s"], w["z"], quant.a_bits, quant.w_bits,
            a_scale=a_scale,
            engine=_signed_engine(x, w["q"].shape[-1], quant))
    if quant.engine == "fp" or quant.w_bits >= 32 or (
            role in ("first", "last") and quant.first_last_fp):
        return x @ w.to(x.dtype)
    if mode == "serve":
        raise ValueError("serve-mode qdense takes prequantized weights: call "
                         "prequantize_params first")
    aq = fake_quant_act_signed(x, quant.a_bits)
    wq = quantize_weight(w, quant.w_bits).to(x.dtype)
    return aq @ wq


def _signed_engine(x: torch.Tensor, n_out: int, quant: QuantConfig) -> str:
    """Level-GEMM engine of the signed serve path: an explicit ``planes`` /
    ``packed`` / ``int8`` / ``f32dot`` from the config, else the
    dispatcher's pick (an installed plan's dense table first), with every
    engine that is not a signed one (the unsigned fused / faithful
    epilogues) mapped to ``int8``."""
    if quant.engine in SIGNED_ENGINES:
        return quant.engine
    from repro_torch.kernels.ops import select_engine

    m = x.numel() // max(x.shape[-1], 1)
    eng = select_engine(m, x.shape[-1], n_out, quant.a_bits, quant.w_bits,
                        device=x.device)
    return eng if eng in SIGNED_ENGINES else "int8"


def prequantize_params(params, cfg):
    """Serve-time transform: every projection weight of the stacked block
    params, (L, K, N) float, becomes ``{"q": (L, K, N) int8 levels,
    "s": (L,) float32, "z": (L,) float32}`` (levels per layer)."""
    out = dict(params)
    blocks = {}
    for kind, tree in params["blocks"].items():
        new = {}
        for sub, sv in tree.items():
            if isinstance(sv, dict):
                new[sub] = {k: (_quantize_stacked(v, cfg.quant.w_bits)
                                if k in PREQUANT_KEYS else v)
                            for k, v in sv.items()}
            else:
                new[sub] = sv
        blocks[kind] = new
    out["blocks"] = blocks
    return out


def _quantize_stacked(w: torch.Tensor, bits: int) -> dict:
    if bits > 7:
        raise ValueError(f"int8 weight levels need w_bits <= 7, got {bits}")
    qs, ss, zs = [], [], []
    for wl in w:
        lv, s, z = weight_levels(wl, bits)
        qs.append(lv.to(torch.int8))
        ss.append(s.float())
        zs.append(z.float())
    return {"q": torch.stack(qs), "s": torch.stack(ss), "z": torch.stack(zs)}


# ---------------------------------------------------------------------------
# Norms & RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """(cos, sin) of the rotary angles, (..., S, 1, hd/2) float32: one pair
    serves every layer of a step."""
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs          # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         tables=None) -> torch.Tensor:
    """x (..., S, H, hd), positions (..., S) or (S,) -> rotated x;
    ``tables`` are :func:`rope_tables` of the same positions."""
    half = x.shape[-1] // 2
    cos, sin = (tables if tables is not None
                else rope_tables(positions, x.shape[-1], theta))
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _mask(iq: torch.Tensor, jk: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """iq (Sq,), jk (Skv,) absolute positions; jk < 0 marks invalid slots."""
    m = (jk[None, :] >= 0).expand(iq.shape[0], -1)
    if causal:
        m = m & (jk[None, :] <= iq[:, None])
    if window is not None:
        m = m & (jk[None, :] > (iq[:, None] - window))
    return m


def expand_kv(k, v, n_q_real: int, n_q_padded: int):
    """GQA: query head j attends KV head ``min(j // g, Hkv - 1)``."""
    hkv = k.shape[2]
    if hkv == n_q_padded:
        return k, v
    g = max(n_q_real // hkv, 1)
    idx = torch.clamp(torch.arange(n_q_padded, device=k.device) // g,
                      max=hkv - 1)
    return k.index_select(2, idx), v.index_select(2, idx)


def attn_full(q, k, v, *, causal: bool, window: Optional[int], q_pos,
              kv_pos) -> torch.Tensor:
    """Materialized-logits attention.  q (B,Sq,H,hd); k, v (B,Skv,H,hd)
    (KV expanded for GQA).  The logits are float32 (bf16 x bf16 products
    are exact in float32, as the reference's ``preferred_element_type``
    keeps them); the softmax weights are cast to v's dtype for P @ V."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float())
    logits = logits / math.sqrt(hd)
    m = _mask(q_pos, kv_pos, causal, window)
    logits = torch.where(m[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def _chunk_plan(n: int, target: int) -> tuple[int, int]:
    """(chunk, padded_n) of the online-softmax scan: n padded up to a
    multiple of the target chunk (never a chunk shrunk to a divisor of a
    prime length); padded slots carry position -1, which ``_mask`` drops."""
    c = min(target, n)
    return c, -(-n // c) * c


def _pad_chunk_dim(x: torch.Tensor, padded: int, axis: int = 1):
    pad = padded - x.shape[axis]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _pad_positions(pos: torch.Tensor, padded: int) -> torch.Tensor:
    pad = padded - pos.shape[0]
    if pad == 0:
        return pos
    return torch.cat([pos, pos.new_full((pad,), -1)])


def attn_banded(q, k, v, *, window: int, q_pos, kv_pos) -> torch.Tensor:
    """Sliding-window attention over the window band only: q block i (of
    ``window`` rows) attends KV ``[max(0, (i-1)W), (i+1)W)``, so the work
    is ~2·S·W logits instead of S^2."""
    sq, w = q.shape[1], window
    outs = []
    for i in range(-(-sq // w)):
        q0, q1 = i * w, min((i + 1) * w, sq)
        k0 = max(0, (i - 1) * w)
        outs.append(attn_full(
            q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], causal=True, window=w,
            q_pos=q_pos[q0:q1], kv_pos=kv_pos[k0:q1]))
    return torch.cat(outs, dim=1)


def attn_chunked(q, k, v, *, causal: bool, window: Optional[int], q_pos,
                 kv_pos, q_chunk: int = 1024, kv_chunk: int = 1024,
                 skip_masked: bool = True) -> torch.Tensor:
    """Online-softmax attention in O(chunk^2) memory: a loop over q chunks
    with an inner loop over KV chunks (the flash dataflow in plain
    PyTorch), lengths padded to whole chunks.  A KV chunk wholly masked
    for a q chunk (the causal upper triangle, out-of-window bands, all
    padding) is skipped: its softmax weights are all zero, so skipping
    leaves the running (max, sum, acc) exactly as computing it would."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    q_chunk, sq_p = _chunk_plan(sq, q_chunk)
    kv_chunk, skv_p = _chunk_plan(skv, kv_chunk)
    q = _pad_chunk_dim(q, sq_p)
    k = _pad_chunk_dim(k, skv_p)
    v = _pad_chunk_dim(v, skv_p)
    q_pos = _pad_positions(q_pos, sq_p)
    kv_pos = _pad_positions(kv_pos, skv_p)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for q0 in range(0, sq_p, q_chunk):
        qi = q[:, q0:q0 + q_chunk].transpose(1, 2)     # (B, H, Cq, hd)
        qpos = q_pos[q0:q0 + q_chunk]
        qmax, qmin = qpos.max(), qpos.min()
        m_run = qi.new_full((b, h, q_chunk), NEG_INF, dtype=torch.float32)
        l_run = qi.new_zeros((b, h, q_chunk), dtype=torch.float32)
        acc = qi.new_zeros((b, h, q_chunk, hd), dtype=torch.float32)
        for k0 in range(0, skv_p, kv_chunk):
            kpos = kv_pos[k0:k0 + kv_chunk]
            if skip_masked:
                alive = kpos >= 0
                if causal:
                    alive &= kpos <= qmax
                if window is not None:
                    alive &= kpos > qmin - window
                if not bool(alive.any()):
                    continue
            kj = k[:, k0:k0 + kv_chunk].transpose(1, 2)
            vj = v[:, k0:k0 + kv_chunk].transpose(1, 2)
            s = torch.einsum("bhqd,bhsd->bhqs", qi.float(), kj.float()) * scale
            msk = _mask(qpos, kpos, causal, window)[None, None]
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m_run, s.max(dim=-1).values)
            p = torch.exp(s - m_new[..., None]) * msk
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            # p rounded to v's dtype as the reference rounds it; the
            # products are exact in float32
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bhsd->bhqd", p.to(vj.dtype).float(), vj.float())
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(out.to(q.dtype).transpose(1, 2))
    return torch.cat(outs, dim=1)[:, :sq]


def _head_mask(cfg, plan, dtype, device):
    hp = plan.padded_heads(cfg.n_heads)
    if hp == cfg.n_heads:
        return None
    return (torch.arange(hp, device=device) < cfg.n_heads).to(dtype)


def attn_quantized(quant: QuantConfig, qmode: str) -> bool:
    """Is this the integer-levels serve path (quantized-flash eligible)?"""
    return (qmode == "serve" and quant.engine != "fp"
            and quant.w_bits < 32 and quant.a_bits <= 8)


def resolve_attn_engine(cfg, *, seq_q: int, seq_kv: int, heads: int,
                        causal: bool, window: Optional[int],
                        qmode: str = "serve") -> str:
    from repro_torch.kernels.ops import AttnShape, select_attn_engine

    return select_attn_engine(AttnShape(
        seq_q=seq_q, seq_kv=seq_kv, heads=heads, head_dim=cfg.hd,
        causal=bool(causal), window=window,
        quantized=attn_quantized(cfg.quant, qmode),
        banded_ok=bool(cfg.banded_attn)))


def attention_fwd(p, x, cfg, plan, *, mode: str, pos_offset=0,
                  cache_k=None, cache_v=None, cache_pos=None,
                  cache_table=None, valid_len=None,
                  window: Optional[int] = None, causal: Optional[bool] = None,
                  engine: Optional[str] = None, qmode: str = "serve",
                  reference: bool = False, rope_cs=None, rows=None):
    """Returns ``(out, (k, v, pos))``.

    ``mode``: ``'prefill'`` (contiguous positions from ``pos_offset``, the
    new cache entries returned), ``'decode'`` (S == 1 at the Python int
    ``pos_offset``, written into the cache slot in place; always the
    ``full`` engine) or ``'paged'`` (the continuous-batching path: the
    cache arguments are the page pools, ``cache_table`` the (B, P) page
    table, ``pos_offset``/``valid_len`` per-slot (B,) int tensors).
    ``rope_cs`` (:func:`rope_tables`) and, for ``'paged'``, ``rows``
    (:func:`paged_rows`) depend only on the step's positions: the layer
    loop computes them once per step."""
    B, S, _ = x.shape
    hd = cfg.hd
    hp = plan.padded_heads(cfg.n_heads)
    hkv = cfg.n_kv_heads
    causal = cfg.causal if causal is None else causal
    h = rms_norm(x, p["ln"])
    q = qdense(h, p["wq"], cfg.quant, mode=qmode).reshape(B, S, hp, hd)
    k = qdense(h, p["wk"], cfg.quant, mode=qmode).reshape(B, S, hkv, hd)
    v = qdense(h, p["wv"], cfg.quant, mode=qmode).reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if mode == "paged":
        if rows is None:
            rows = paged_rows(cache_table, pos_offset, valid_len, S,
                              cache_pos.shape[1], cache_pos.shape[0] - 1)
        out, new_cache = _paged_attn_fwd(
            q, k, v, cfg, rows, cache_k, cache_v, cache_pos, cache_table,
            causal=causal, window=window, qmode=qmode, reference=reference,
            rope_cs=rope_cs)
    else:
        q_pos = pos_offset + torch.arange(S, device=x.device)
        k_roped = rope(k, q_pos, cfg.rope_theta, rope_cs)
        q = rope(q, q_pos, cfg.rope_theta, rope_cs)
        if mode == "prefill":
            kv, vv, kv_pos = k_roped, v, q_pos
            new_cache = (k_roped, v, q_pos[None].expand(B, S).to(torch.int32))
        elif mode == "decode":
            slots = cache_k.shape[1]
            at = pos_offset % slots if window is not None else pos_offset
            cache_k[:, at:at + 1] = k_roped
            cache_v[:, at:at + 1] = v
            cache_pos[:, at] = pos_offset
            kv, vv, kv_pos = cache_k, cache_v, cache_pos[0]
            new_cache = (cache_k, cache_v, cache_pos)
        else:
            raise ValueError(f"attention mode {mode!r} is not served "
                             f"(prefill | decode | paged)")
        kv, vv = expand_kv(kv, vv, cfg.n_heads, hp)
        if mode == "decode":
            engine = "full"
        elif engine is None:
            engine = resolve_attn_engine(
                cfg, seq_q=S, seq_kv=kv.shape[1], heads=hp, causal=causal,
                window=window, qmode=qmode)
        if engine == "banded" and window is not None and S > 2 * window:
            out = attn_banded(q, kv, vv, window=window, q_pos=q_pos,
                              kv_pos=kv_pos)
        elif engine == "flash" and S == kv.shape[1]:
            # flash tiles contiguous prefill positions; ragged cache
            # geometries take the position-indexed chunked scan below
            from repro_torch.kernels.attn_flash import attn_flash

            bits = min(cfg.quant.a_bits, 8)
            out = attn_flash(q, kv, vv, causal=bool(causal), window=window,
                             q_bits=bits, k_bits=bits,
                             reference=reference).to(q.dtype)
        elif engine in ("chunked", "banded", "flash"):
            out = attn_chunked(q, kv, vv, causal=causal, window=window,
                               q_pos=q_pos, kv_pos=kv_pos)
        elif engine == "full":
            out = attn_full(q, kv, vv, causal=causal, window=window,
                            q_pos=q_pos, kv_pos=kv_pos)
        else:
            raise ValueError(f"unknown attention engine {engine!r}")
    hm = _head_mask(cfg, plan, out.dtype, out.device)
    if hm is not None:
        out = out * hm[None, None, :, None]
    out = qdense(out.reshape(B, S, hp * hd), p["wo"], cfg.quant, mode=qmode)
    return out, new_cache


def paged_rows(table, pos_offset, valid_len, S: int, ps: int,
               null: int) -> dict:
    """Where one paged step's rows go: ``q_pos`` (B, S) positions, ``ok``
    (the valid rows: within ``valid_len`` and the table), and each row's
    write target ``(page, off)``.  The reference scatters the invalid rows
    to an out-of-bounds index with ``mode='drop'``; PyTorch has no drop
    mode, so here every invalid row targets slot 0 of the null page (and
    writes back that slot's own values, see :func:`_paged_attn_fwd`)."""
    P = table.shape[1]
    ar = torch.arange(S, dtype=torch.int32, device=table.device)
    q_pos = pos_offset.to(torch.int32)[:, None] + ar[None]
    ok = (ar[None] < valid_len[:, None]) & (q_pos >= 0) & (q_pos < P * ps)
    page = torch.gather(table, 1, torch.clamp(q_pos // ps, 0, P - 1).long())
    return dict(q_pos=q_pos, ok=ok, page=torch.where(ok, page, null).long(),
                off=torch.where(ok, q_pos % ps, 0).long(),
                q_pos_masked=torch.where(ok, q_pos, -1))


def _paged_attn_fwd(q, k, v, cfg, rows, pool_k, pool_v, ppos, table, *,
                    causal: bool, window: Optional[int], qmode: str,
                    reference: bool, rope_cs=None):
    """One paged step: write this step's valid K/V rows into the page pools
    (in place), then attend each slot over its own page-table row.  The
    invalid rows write the null page's own slot-0 values back, so the
    write leaves it as it was and no valid row shares that target."""
    from repro_torch.kernels.attn_flash import attn_paged
    from repro_torch.kernels.ops import AttnShape, select_attn_engine

    hd = k.shape[3]
    ps = ppos.shape[1]
    null = ppos.shape[0] - 1
    q_pos, ok, page, off = rows["q_pos"], rows["ok"], rows["page"], rows["off"]
    k_roped = rope(k, q_pos, cfg.rope_theta, rope_cs)
    q = rope(q, q_pos, cfg.rope_theta, rope_cs)
    okx = ok[..., None, None]
    pool_k.index_put_((page, off), torch.where(okx, k_roped, pool_k[null, 0]))
    pool_v.index_put_((page, off), torch.where(okx, v, pool_v[null, 0]))
    ppos.index_put_((page, off), torch.where(ok, q_pos, ppos[null, 0]))

    attn = AttnShape(
        seq_q=q.shape[1], seq_kv=table.shape[1] * ps, heads=q.shape[2],
        head_dim=hd, causal=bool(causal), window=window,
        quantized=attn_quantized(cfg.quant, qmode), page_size=ps)
    eng = select_attn_engine(attn)
    if eng != "paged":
        raise ValueError(f"paged attention geometry resolved to engine "
                         f"{eng!r}")
    out = attn_paged(q, pool_k, pool_v, ppos, table, rows["q_pos_masked"],
                     causal=bool(causal), window=window,
                     quantized=attn.quantized,
                     bits=min(cfg.quant.a_bits, 8), n_q_heads=cfg.n_heads,
                     reference=reference)
    return out.to(q.dtype), (pool_k, pool_v, ppos)


# ---------------------------------------------------------------------------
# Activations, written as the reference's jax.nn functions compute them
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` (``jax.nn.silu``): two roundings in a bf16
    compute dtype, not torch's fused one."""
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form), op for op."""
    c = math.sqrt(2 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


# ---------------------------------------------------------------------------
# Param init helpers (stacked: a leading axis of n layers)
# ---------------------------------------------------------------------------

def dense_init(gen, shape, fan_in: int, device,
               scale: float | None = None) -> torch.Tensor:
    """N(0, 1) x ``scale`` (default ``1/sqrt(fan_in)``), float32."""
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, device=device).mul_(s)


def init_attention(gen, cfg, plan, n: int, device) -> dict:
    d, hd = cfg.d_model, cfg.hd
    hp, hkv = plan.padded_heads(cfg.n_heads), cfg.n_kv_heads
    p = {"ln": torch.ones((n, d), device=device),
         "wq": dense_init(gen, (n, d, hp * hd), d, device),
         "wk": dense_init(gen, (n, d, hkv * hd), d, device),
         "wv": dense_init(gen, (n, d, hkv * hd), d, device),
         "wo": dense_init(gen, (n, hp * hd, d), hp * hd, device)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((n, hd), device=device)
        p["k_norm"] = torch.ones((n, hd), device=device)
    return p


def init_mlp(gen, cfg, n: int, device, d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {"ln": torch.ones((n, d), device=device),
         "w_in": dense_init(gen, (n, d, ff), d, device)}
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(gen, (n, d, ff), d, device)
    p["w_out"] = dense_init(gen, (n, ff, d), ff, device)
    return p


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------

def mlp_fwd(p, x, cfg, *, norm: bool = True, qmode: str = "train"):
    h = rms_norm(x, p["ln"]) if norm else x
    up = qdense(h, p["w_in"], cfg.quant, mode=qmode)
    if cfg.act == "swiglu":
        up = silu(qdense(h, p["w_gate"], cfg.quant, mode=qmode)) * up
    else:
        up = gelu_tanh(up)
    return qdense(up, p["w_out"], cfg.quant, mode=qmode)


# ---------------------------------------------------------------------------
# Mixture-of-Experts (token-choice top-k, capacity-based gather dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen, cfg, plan, n: int, device) -> dict:
    d, E, eff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    p = {"ln": torch.ones((n, d), device=device),
         "router": dense_init(gen, (n, d, E), d, device),
         "w1": dense_init(gen, (n, E, d, eff), d, device),
         "wg": dense_init(gen, (n, E, d, eff), d, device),
         "w2": dense_init(gen, (n, E, eff, d), eff, device)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, n, device,
                               d_ff=eff * cfg.n_shared_experts)
    return p


def moe_route(p, h: torch.Tensor, cfg) -> dict:
    """Routing of ``h`` (T, d), the normed tokens: the router's softmax,
    top-k (ties to the lower expert index, as ``lax.top_k``), normalized
    gates, each (token, k) slot's position in its expert's buffer (a
    cumsum over the token-major (T*k) order, so which slots overflow the
    capacity depends on that order) and ``keep`` (T*k,) = the slot is
    within ``ceil(cf * T * k / E)`` slots of this call.  Also the
    Switch-style load-balancing aux loss."""
    E, k = cfg.n_experts, cfg.top_k
    logits = (h @ p["router"].to(h.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = order.values[:, :k], order.indices[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = (me * ce).sum() * E * cfg.router_aux_coef
    e_flat = idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(e_flat, E)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    # capacity: at least 4 slots (tiny decode batches never drop), at most
    # T (an expert receives a token at most once)
    T = h.shape[0]
    cap = min(T, max(int(math.ceil(cfg.capacity_factor * T * k / E)), 4))
    return dict(gates=gates, idx=idx, e_flat=e_flat, pos=pos,
                keep=pos < cap, capacity=cap, aux=aux)


def moe_fwd(p, x, cfg):
    """x (B,S,d) -> (out, aux_loss).  Capacity-dropped token-choice routing
    with gather dispatch: each kept (token, k) slot's normed token goes to
    row ``pos`` of its expert's (C, d) buffer, the experts' SwiGLU runs as
    three float einsums over the (E, C, d) buffer, and each token sums its
    k gated slot outputs in slot order (a (T, k, d) view summed over k,
    deterministic on every device, as the reference's ``segment_sum``
    adds them).  The shared experts (a train-mode :func:`mlp_fwd` on the
    normed tokens) are added last."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    h = rms_norm(x.reshape(T, d), p["ln"])
    r = moe_route(p, h, cfg)
    keep, e_flat, pos = r["keep"], r["e_flat"], r["pos"]
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    cap = r["capacity"]
    # dropped slots all land on a spare row past the capacity, cut off
    # below (no host sync on the mask; kept slots are unique)
    buf = h.new_zeros((E, cap + 1, d))
    buf.index_put_((e_flat, torch.where(keep, pos, cap)), h[tok])
    buf = buf[:, :cap]
    up = torch.einsum("ecd,edf->ecf", buf, p["w1"].to(h.dtype))
    gate = torch.einsum("ecd,edf->ecf", buf, p["wg"].to(h.dtype))
    y_e = torch.einsum("ecf,efd->ecd", silu(gate) * up, p["w2"].to(h.dtype))
    y_slots = y_e[torch.where(keep, e_flat, 0), torch.where(keep, pos, 0)]
    y_slots = torch.where(keep[:, None], y_slots, 0.0)
    contrib = (y_slots * r["gates"].reshape(-1).to(h.dtype)[:, None]
               ).reshape(T, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    if cfg.n_shared_experts:
        y = y + mlp_fwd(p["shared"], h, cfg, norm=False)
    return y.reshape(B, S, d), r["aux"]

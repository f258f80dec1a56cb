"""RecurrentGemma recurrent block (arXiv:2402.19427): RG-LRU + causal
depthwise conv (port of ``repro/models/rglru.py``).

The in/out projections ``wx``, ``wy``, ``wo`` run through :func:`qdense`
in its default train mode (the reference's serve path leaves these
weights float: its prequantization does not reach them, so they take the
fake-quant product); the gate products ``wr``/``wi`` and the recurrence
are float, as in the reference.  The recurrence is the reference's
sequential scan, a Python loop over positions in float32; the parallel
``associative_scan`` form the reference keeps for its dry-run analysis is
not ported.
"""
from __future__ import annotations


import torch

from .layers import dense_init, gelu_tanh, qdense, rms_norm, softplus

RGLRU_C = 8.0  # the paper's recurrence sharpness constant


def init_rec_block(gen, cfg, plan, n: int, device) -> dict:
    """n stacked blocks: N(0, 1/fan_in) projections, the conv taps
    N(0, 1/cw), zero conv bias, and Λ drawn so a^c lies in (0.9, 0.999)
    as in the paper."""
    d = cfg.d_model
    W = cfg.lru_width or d
    cw = cfg.conv_width
    u = torch.rand((n, W), generator=gen, device=device) * (0.999 - 0.9) + 0.9
    return {
        "ln": torch.ones((n, d), device=device),
        "wx": dense_init(gen, (n, d, W), d, device),
        "wy": dense_init(gen, (n, d, W), d, device),
        "conv_w": dense_init(gen, (n, cw, W), cw, device),
        "conv_b": torch.zeros((n, W), device=device),
        "wr": dense_init(gen, (n, W, W), W, device),
        "wi": dense_init(gen, (n, W, W), W, device),
        "lam": torch.log(torch.exp(-torch.log(u) / RGLRU_C) - 1.0),
        "wo": dense_init(gen, (n, W, d), W, device),
    }


def _causal_conv1d(x, w, b, carry):
    """Depthwise causal conv.  x (B,S,W), w (cw,W), carry (B,cw-1,W).  The
    taps are summed in tap order, as the reference's Python ``sum``."""
    cw, S = w.shape[0], x.shape[1]
    xp = torch.cat([carry.to(x.dtype), x], dim=1)
    out = xp[:, 0:S, :] * w[0].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + S, :] * w[i].to(x.dtype)
    new_carry = xp[:, xp.shape[1] - (cw - 1):, :]
    return out + b.to(x.dtype), new_carry


def _rglru_scan(xg, a, h0):
    """h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * xg_t, all (B,S,W) float32;
    -> (h for every t, the last h)."""
    u = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * xg
    h, hs = h0, []
    for t in range(xg.shape[1]):
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rec_block_fwd(p, x, cfg, plan, *, mode: str, state=None):
    """x (B,S,d); state: dict(h (B,W) float32, conv (B,cw-1,W) float32)
    or None (zeros).  Returns (out, new_state)."""
    B, S, d = x.shape
    W = cfg.lru_width or d
    cw = cfg.conv_width
    if state is None:
        state = dict(
            h=torch.zeros((B, W), dtype=torch.float32, device=x.device),
            conv=torch.zeros((B, cw - 1, W), dtype=torch.float32,
                             device=x.device))
    h_in = rms_norm(x, p["ln"])
    xb = qdense(h_in, p["wx"], cfg.quant)
    yb = gelu_tanh(qdense(h_in, p["wy"], cfg.quant))
    xc, conv_new = _causal_conv1d(xb, p["conv_w"], p["conv_b"], state["conv"])
    r = torch.sigmoid(xc @ p["wr"].to(xc.dtype)).float()
    i = torch.sigmoid(xc @ p["wi"].to(xc.dtype)).float()
    a = torch.exp(-RGLRU_C * softplus(p["lam"].float()) * r)
    h_seq, h_last = _rglru_scan(i * xc.float(), a, state["h"])
    out = qdense(h_seq.to(x.dtype) * yb, p["wo"], cfg.quant)
    return out, dict(h=h_last, conv=conv_new.float())



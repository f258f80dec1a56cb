"""RecurrentGemma recurrent block (arXiv:2402.19427): RG-LRU + causal
depthwise conv (port of ``repro/models/rglru.py``).

The in/out projections ``wx``, ``wy``, ``wo`` run through :func:`qdense`
in its default train mode (the reference's serve path leaves these
weights float: its prequantization does not reach them, so they take the
fake-quant product); the gate products ``wr``/``wi`` and the recurrence
are float, as in the reference.  The recurrence runs in float32 in one
of the reference's two forms: the sequential scan (:func:`_rglru_scan`, a
Python loop over positions, the default) or, with ``cfg.rglru_assoc`` or
``rec_block_fwd(use_assoc=True)``, the parallel form
(:func:`_rglru_assoc`, ceil(log2 S) steps of whole-sequence tensor ops).
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


def rec_block_axes(cfg) -> dict:
    """Logical axes of one RG-LRU block's params (the reference's)."""
    return {"ln": ("embed",), "wx": ("embed", "mlp"), "wy": ("embed", "mlp"),
            "conv_w": (None, "mlp"), "conv_b": ("mlp",),
            "wr": (None, "mlp"), "wi": (None, "mlp"), "lam": ("mlp",),
            "wo": ("mlp", "embed")}


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


def _rglru_assoc(xg, a, h0):
    """The same recurrence in parallel form: ``h_t = a_t h_{t-1} + b_t``
    composes associatively as ``(a, b) * (a', b') = (a a', a' b + b')``,
    so with ``h0`` folded into ``b_0`` (as the reference's
    ``associative_scan`` form does) a Hillis-Steele scan takes
    ceil(log2 S) steps, each one whole-sequence multiply-add.  The
    products associate in another order than the sequential loop's, so
    the two agree to float32 rounding, not bit for bit."""
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * xg
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S, d = xg.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b, b[:, -1]


def rec_block_fwd(p, x, cfg, plan, *, mode: str, state=None,
                  use_assoc: bool = False):
    """x (B,S,d); state: dict(h (B,W) float32, conv (B,cw-1,W) float32)
    or None (zeros).  The recurrence takes :func:`_rglru_assoc` when
    ``use_assoc`` or ``cfg.rglru_assoc``, else :func:`_rglru_scan`.
    Returns (out, new_state)."""
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
    scan = _rglru_assoc if (use_assoc or cfg.rglru_assoc) else _rglru_scan
    h_seq, h_last = scan(i * xc.float(), a, state["h"])
    out = qdense(h_seq.to(x.dtype) * yb, p["wo"], cfg.quant)
    return out, dict(h=h_last, conv=conv_new.float())



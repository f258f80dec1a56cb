"""RWKV-6 "Finch" block (arXiv:2404.05892): data-dependent decay linear
attention + channel mix (port of ``repro/models/rwkv6.py``).

Every projection runs through :func:`qdense` in its default train mode:
the block's params are one flat dict, which the reference's one-level
prequantization never reaches, so its serve path takes the fake-quant
product for all of them.  The decay LoRA and the recurrence are float,
the recurrence the reference's sequential scan as a Python loop over
positions (state float32).
"""
from __future__ import annotations

import torch

from .layers import dense_init, qdense, rms_norm, silu

N_LORA = 5  # w, k, v, r, g


def init_rwkv_block(gen, cfg, plan, n: int, device) -> dict:
    d, hd, r = cfg.d_model, cfg.rwkv_head_dim, cfg.lora_rank
    H = d // hd
    z = lambda *s: torch.zeros((n,) + s, device=device)  # noqa: E731
    o = lambda *s: torch.ones((n,) + s, device=device)   # noqa: E731
    p = {"ln1": o(d), "ln2": o(d),
         # token-shift ddlerp
         "mu_base": z(d), "mus": z(N_LORA, d),
         "lora_A": dense_init(gen, (n, d, N_LORA, r), d, device, scale=0.01),
         "lora_B": dense_init(gen, (n, N_LORA, r, d), r, device, scale=0.01),
         # decay base
         "lam": torch.full((n, d), -2.0, device=device), "u": z(H, hd)}
    for nm in ("wr", "wk", "wv", "wg", "wo"):
        p[nm] = dense_init(gen, (n, d, d), d, device)
    p["ln_x"] = o(H, hd)
    # channel mix
    p["cm_mu_k"], p["cm_mu_r"] = z(d), z(d)
    p["cm_wk"] = dense_init(gen, (n, d, cfg.d_ff), d, device)
    p["cm_wv"] = dense_init(gen, (n, cfg.d_ff, d), cfg.d_ff, device)
    p["cm_wr"] = dense_init(gen, (n, d, d), d, device)
    return p


def rwkv_block_axes(cfg) -> dict:
    """Logical axes of one RWKV-6 block's params (the reference's)."""
    a = {"ln1": ("embed",), "ln2": ("embed",), "mu_base": ("embed",),
         "mus": (None, "embed"), "lora_A": ("embed", None, None),
         "lora_B": (None, None, "embed"), "lam": ("embed",),
         "u": ("heads", None)}
    for nm in ("wr", "wk", "wv", "wg"):
        a[nm] = ("embed", "heads")
    a["wo"] = ("heads", "embed")
    a["ln_x"] = ("heads", None)
    a.update(cm_mu_k=("embed",), cm_mu_r=("embed",), cm_wk=("embed", "mlp"),
             cm_wv=("mlp", "embed"), cm_wr=("embed", "heads"))
    return a


def _shift(x, last):
    """Token shift: x_{t-1}, with the carried-in ``last`` (B,d) at t=0."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _wkv_scan(r, k, v, w, u, s0):
    """Linear-attention recurrence, a loop over positions.

    r,k,w (B,S,H,K); v (B,S,H,V); u (H,K); s0 (B,H,K,V).
    o_t = r_t . (S + u*k_t (x) v_t);  S <- diag(w_t) S + k_t (x) v_t
    """
    s, outs = s0, []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]
        o = torch.einsum("bhk,bhkv->bhv", r_t, s) + (
            torch.sum(r_t * u[None] * k_t, dim=-1, keepdim=True) * v_t)
        s = w_t[..., None] * s + kv
        outs.append(o)
    return torch.stack(outs, dim=1), s


def rwkv_block_fwd(p, x, cfg, plan, *, mode: str, state=None):
    """x (B,S,d); state: dict(tm_x, cm_x (B,d) in the compute dtype,
    s (B,H,K,V) float32) or None (zeros).  Returns (x out, new_state)."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    if state is None:
        state = dict(
            tm_x=torch.zeros((B, d), dtype=x.dtype, device=x.device),
            cm_x=torch.zeros((B, d), dtype=x.dtype, device=x.device),
            s=torch.zeros((B, H, hd, hd), dtype=torch.float32,
                          device=x.device))
    # ---- time mix ----
    h = rms_norm(x, p["ln1"])
    dx = _shift(h, state["tm_x"]) - h
    xxx = h + dx * p["mu_base"].to(h.dtype)
    sel = torch.tanh(torch.einsum("bsd,dnr->bsnr", xxx,
                                  p["lora_A"].to(h.dtype)))
    sel = torch.einsum("bsnr,nrd->bsnd", sel, p["lora_B"].to(h.dtype))
    mixed = h[:, :, None, :] + dx[:, :, None, :] * (
        p["mus"].to(h.dtype)[None, None] + sel)          # (B,S,5,d)
    xw, xk, xv, xr, xg = (mixed[:, :, i] for i in range(N_LORA))
    w = torch.exp(-torch.exp(p["lam"].float() + xw.float()))
    r = qdense(xr, p["wr"], cfg.quant).reshape(B, S, H, hd)
    k = qdense(xk, p["wk"], cfg.quant).reshape(B, S, H, hd)
    v = qdense(xv, p["wv"], cfg.quant).reshape(B, S, H, hd)
    g = silu(qdense(xg, p["wg"], cfg.quant))
    o, s_new = _wkv_scan(r.float(), k.float(), v.float(),
                         w.reshape(B, S, H, hd), p["u"].float(), state["s"])
    # per-head group norm; the population variance (jnp.var), two-pass
    o = o - o.mean(dim=-1, keepdim=True)
    c = o - o.mean(dim=-1, keepdim=True)
    var = (c * c).sum(dim=-1) / hd
    o = o * torch.rsqrt(var + 1e-6)[..., None]
    o = (o * p["ln_x"].float()[None, None]).to(x.dtype)
    x = x + qdense(o.reshape(B, S, d) * g, p["wo"], cfg.quant)
    new_tm = h[:, -1, :]
    # ---- channel mix ----
    h2 = rms_norm(x, p["ln2"])
    dx2 = _shift(h2, state["cm_x"]) - h2
    xk2 = h2 + dx2 * p["cm_mu_k"].to(h2.dtype)
    xr2 = h2 + dx2 * p["cm_mu_r"].to(h2.dtype)
    kk = torch.square(torch.relu(qdense(xk2, p["cm_wk"], cfg.quant)))
    out = torch.sigmoid(qdense(xr2, p["cm_wr"], cfg.quant)) * qdense(
        kk, p["cm_wv"], cfg.quant)
    return x + out, dict(tm_x=new_tm, cm_x=h2[:, -1, :], s=s_new)

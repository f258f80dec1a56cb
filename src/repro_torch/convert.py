"""Carry CNN and LM weights across from the JAX package to the port.

The JAX package's params arrive as numpy (or anything ``np.asarray``
accepts): a list of per-layer dicts, either float (``init_cnn``: ``w``
HWIO, ``b``, ``g``, ``beta``) or prequantized (``w_lv`` (K, Cout) levels,
``s_w``, ``z_w`` plus the float ``b``/``g``/``beta``).  The port's params
are the same dicts with float32 tensors, uint8 levels and the scales as
Python floats holding their float32 values.  Nothing is requantized, so a
test can hold the port against the reference's own levels and scales.

LM params (``lm_params_from_numpy``) keep the reference's tree: stacked
per-layer blocks, each prequantized projection ``{"q": (L, K, N) int8
levels, "s": (L,) float32, "z": (L,) float32}``, the rest float32 — the
encoder's ``frame_proj`` (its tree has no ``embed``) and the VLM's
``vision_proj`` among them.

A CNN or LM plan the reference's ``save_plan`` wrote is the port's second
source of weights (:func:`plan_from_reference`).
"""
from __future__ import annotations

import numpy as np
import torch

_SCALARS = ("s_w", "z_w")


def cnn_params_from_numpy(params, device="cuda") -> list[dict]:
    out = []
    for p in params:
        q = {}
        for k, v in p.items():
            a = np.asarray(v)
            if k in _SCALARS:
                q[k] = float(np.float32(a))
            elif k == "w_lv":
                if a.min() < 0 or a.max() > 255:
                    raise ValueError(f"w_lv levels outside [0, 255]: "
                                     f"[{a.min()}, {a.max()}]")
                q[k] = torch.from_numpy(a.astype(np.uint8)).to(device)
            else:
                q[k] = torch.from_numpy(np.array(a, np.float32)).to(device)
        out.append(q)
    return out


def lm_params_from_numpy(params, cfg, device="cuda") -> dict:
    """The reference's LM params (``init_lm``, optionally through
    ``prequantize_params``), as numpy, -> the port's tree of tensors.
    ``cfg``: the ArchConfig, or its QuantConfig."""
    w_max = (1 << getattr(cfg, "quant", cfg).w_bits) - 1

    def leaf(k, v):
        a = np.asarray(v)
        if k == "q":
            if a.min() < 0 or a.max() > min(w_max, 127):
                raise ValueError(f"weight levels outside [0, {w_max}]: "
                                 f"[{a.min()}, {a.max()}]")
            return torch.from_numpy(a.astype(np.int8)).to(device)
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else leaf(k, v))
                for k, v in tree.items()}

    return walk(params)


def _relabel(key: tuple, at: int) -> tuple:
    return key[:at] + ("cuda",) + key[at + 1:]


def _check_lm_tables(path: str, meta: dict) -> tuple[dict, dict]:
    """A reference LM plan's dense and attention tables, each verdict
    checked feasible on cuda, the backend slot relabelled ``cuda``."""
    from repro_torch.core import plan as P
    from repro_torch.kernels import ops

    dense = {}
    for k, eng in meta.get("dense_table", []):
        _, kk, n, a_bits, w_bits, _ = k
        ok, why = ops.engine_feasible(eng, 1, kk, n, a_bits, w_bits, "cuda")
        if eng not in P.SIGNED_ENGINES or not ok:
            raise P.PlanError(f"{path}: dense verdict {eng!r} at K={kk}, "
                              f"N={n} cannot serve the signed path on cuda"
                              f"{': ' + why if why else ''} — recompile")
        dense[_relabel(tuple(k), 5)] = eng
    attn = {}
    for k, eng in meta.get("attn_table", []):
        k = tuple(k)
        _, sq, heads, hd, causal, window, quantized, _ = k[:8]
        ps, skv = k[8:] if len(k) == 10 else (None, sq)
        ok, why = ops.attn_engine_feasible(eng, ops.AttnShape(
            seq_q=sq, seq_kv=skv, heads=heads, head_dim=hd, causal=causal,
            window=window or None, quantized=quantized, page_size=ps))
        if not ok:
            raise P.PlanError(f"{path}: attention verdict {eng!r} at {k} is "
                              f"infeasible on cuda: {why} — recompile")
        attn[_relabel(k, 7)] = eng
    return dense, attn


def plan_from_reference(path: str, device="cuda"):
    """Read a plan written by the reference's ``save_plan`` as a port
    ``ModelPlan`` with its params on ``device``.

    A ``tpu`` plan routes as ``cuda`` does, so its engine tables are kept,
    checked feasible on ``cuda`` and relabelled ``backend="cuda"``; its
    autotune measurements (taken on another backend) are dropped.  A
    ``cpu`` plan pins the CPU's float engines and is refused.

    CNN plans: the reference's levels (int8, or int32 at 8 bits) become the
    port's uint8, checked against each layer's bit width; faithful layers
    get their weight planes packed (packing is not requantization); the
    layers are re-annotated with the ``cuda`` target's costs.  LM plans:
    the dense and attention tables' backend slots are relabelled; the
    rows keep the reference's cost annotations (they depend on the prompt
    length, which a plan does not store)."""
    import dataclasses

    from repro_torch.core import plan as P
    from repro_torch.kernels import ops

    meta, params = P._read_plan(path)
    backend = meta["backend"]
    if backend == "cpu":
        raise P.PlanError(
            f"{path}: a reference plan compiled for backend 'cpu' pins the "
            "CPU's engine table — recompile it for 'tpu' (which routes as "
            "cuda does) or compile the params with the port")
    if backend not in ("tpu", "cuda"):
        raise P.PlanError(f"{path}: unknown plan backend {backend!r}")
    layers = tuple(P._layer_from_json(d) for d in meta["layers"])
    if meta["kind"] == "lm":
        dense, attn = _check_lm_tables(path, meta)
        plan = P._plan_from_meta(meta, params, device, backend="cuda",
                                 layers=layers)
        return dataclasses.replace(plan, dense_table=dense, attn_table=attn,
                                   autotune={})
    for lp in layers:
        if lp.fp:
            continue
        for b, eng in lp.engines:
            conv = ops.ConvShape(lp.in_h, lp.in_w, lp.kh, lp.kw, lp.stride,
                                 lp.padding, batch=b)
            ok, why = ops.engine_feasible(eng, b * lp.out_h * lp.out_w, lp.k,
                                          lp.cout, lp.a_bits, lp.w_bits,
                                          "cuda", conv)
            if not ok:
                raise P.PlanError(f"{path}: layer {lp.index} ({lp.name}) "
                                  f"engine {eng!r} at batch {b} is "
                                  f"infeasible on cuda: {why} — recompile")
    plan = P._plan_from_meta(meta, params, device, backend="cuda",
                             layers=P._annotate_costs(layers, "cuda"))
    return dataclasses.replace(plan, autotune={})

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
levels, "s": (L,) float32, "z": (L,) float32}``, the rest float32.
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
    ``prequantize_params``), as numpy, -> the port's tree of tensors."""
    w_max = (1 << cfg.quant.w_bits) - 1

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

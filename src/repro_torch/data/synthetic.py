"""Deterministic synthetic datasets (port of ``repro/data/synthetic.py``,
numpy as there, so every array equals the reference's bit for bit).

* ``svhn_like`` — 10-class 40x40x3 digit-ish images: class-conditional
  structured templates (strokes on textured background) + noise.  Rich
  enough that quantization bit-width measurably moves accuracy — which is
  all Table I needs (the *ordering* of W:I configs, not SVHN absolutes).
* ``lm_stream`` — Markov-chain token stream with local structure so an LM
  can beat the unigram floor within a few hundred steps.
"""
from __future__ import annotations

import numpy as np


def _digit_template(cls: int, size: int = 40, seed: int = 1234) -> np.ndarray:
    """Procedural 7-segment-ish digit rendering + per-class texture."""
    rng = np.random.RandomState(seed + cls)
    img = np.zeros((size, size, 3), np.float32)
    # textured background unique to nothing (shared stats)
    img += 0.25
    segs = {  # 7-segment map
        0: [0, 1, 2, 4, 5, 6], 1: [2, 5], 2: [0, 2, 3, 4, 6],
        3: [0, 2, 3, 5, 6], 4: [1, 2, 3, 5], 5: [0, 1, 3, 5, 6],
        6: [0, 1, 3, 4, 5, 6], 7: [0, 2, 5], 8: list(range(7)),
        9: [0, 1, 2, 3, 5, 6],
    }[cls]
    m, w = size // 8, size // 10  # margins, stroke width
    h = size - 2 * m
    coords = {
        0: (slice(m, m + w), slice(m, size - m)),                       # top
        1: (slice(m, m + h // 2), slice(m, m + w)),                     # top-left
        2: (slice(m, m + h // 2), slice(size - m - w, size - m)),       # top-right
        3: (slice(m + h // 2 - w // 2, m + h // 2 + w - w // 2), slice(m, size - m)),
        4: (slice(m + h // 2, size - m), slice(m, m + w)),              # bot-left
        5: (slice(m + h // 2, size - m), slice(size - m - w, size - m)),
        6: (slice(size - m - w, size - m), slice(m, size - m)),         # bottom
    }
    color = 0.5 + 0.5 * rng.rand(3)
    for s in segs:
        img[coords[s]] = color
    return img


_TEMPLATES: dict[int, np.ndarray] = {}


def svhn_like(n: int, *, seed: int = 0, size: int = 40):
    """Returns (images (n,size,size,3) float32 in [0,1], labels (n,) int32)."""
    if size not in _TEMPLATES:
        _TEMPLATES[size] = np.stack([_digit_template(c, size) for c in range(10)])
    t = _TEMPLATES[size]
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.int32)
    imgs = t[labels].copy()
    # global illumination + shifts + noise (SVHN-ish nuisances)
    gain = 0.6 + 0.8 * rng.rand(n, 1, 1, 1).astype(np.float32)
    imgs *= gain
    shift = rng.randint(-3, 4, (n, 2))
    for i in range(n):  # cheap jitter
        imgs[i] = np.roll(imgs[i], shift[i], axis=(0, 1))
    imgs += rng.randn(*imgs.shape).astype(np.float32) * 0.15
    return np.clip(imgs, 0.0, 1.0), labels


def lm_stream(n_tokens: int, vocab: int, *, seed: int = 0, order: int = 1):
    """Markov token stream: P(t|prev) concentrated on ~8 successors."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(0, vocab, (vocab, 8))
    out = np.empty(n_tokens, np.int32)
    t = rng.randint(vocab)
    for i in range(n_tokens):
        out[i] = t
        t = succ[t, rng.randint(8)] if rng.rand() < 0.9 else rng.randint(vocab)
    return out


def lm_batch(step: int, micro: int, *, batch: int, seq: int, vocab: int,
             seed: int = 0):
    """Deterministically addressed LM batch: (tokens, labels)."""
    rng = np.random.RandomState((seed * 1_000_003 + step) * 97 + micro)
    succ_rng = np.random.RandomState(seed)
    succ = succ_rng.randint(0, vocab, (vocab, 8))
    toks = np.empty((batch, seq + 1), np.int32)
    t = rng.randint(0, vocab, batch)
    for i in range(seq + 1):
        toks[:, i] = t
        jump = rng.rand(batch) < 0.1
        t = np.where(jump, rng.randint(0, vocab, batch),
                     succ[t, rng.randint(0, 8, batch)])
    return dict(tokens=toks[:, :-1], labels=toks[:, 1:])

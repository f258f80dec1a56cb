"""How ``correct`` is decided.

The served network is a chain of quantized layers, and one level that
flips at a rounding boundary moves every later layer: two sound float32
implementations that sum in different orders give logits a few percent
of their scale apart on some images, and so does one in TF32.  So the
check reads the chain twice.  During the window it keeps, for a few
forwards drawn from the seed (reservoir sampling over all forwards of the
window), the staged input, the last hidden layer's output, and for a
block of rows drawn from the seed each hidden layer's output, as the
program's per-layer norm (``repro_torch.models.cnn._norm_act``) returns
them.  What it keeps goes to host memory as the forward runs (pinned,
copied without a synchronisation; activations as their levels), so the
device's peak is the program's.  After the window the plain reference
recomputes, and the check compares:

* ``level_flips``: each kept row's layers from the program's output of
  the layer before (the first from the benchmark's own image); the
  largest share, over the hidden layers, of activation levels that differ
  from the reference's;
* ``chain_flips``: every row of the kept forwards through the whole
  chain from its image alone, independent of the program's state; the
  share of the last hidden layer's levels that differ from the program's.
  A share over every row, so a cascade in a few rows does not decide it;
* ``logit_gap``: every answer of the kept forwards (the value the engine
  returned for the request) against the reference's last layer on the
  program's last hidden state; the largest gap, over the largest
  reference logit of the forward;
* ``unmatched``: rows of the kept forwards whose staged input is no image
  of the pool, or whose request got no answer;
* ``missing``: requests of the window that got no answer.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

NUMBERS = ("level_flips", "chain_flips", "logit_gap", "unmatched",
           "missing")
# forwards of the window kept for the check, and the rows of each that
# are followed layer by layer; the same for every cell
FORWARDS = 4
ROWS = 64
# rows the reference runs at once after the window
BLOCK = 256


class Capture:
    """The kept state of a few forwards.  ``begin`` is called with each
    forward's input, ``layer`` with each hidden layer's output, ``end``
    after the forward returns.  The input is kept whole, the last hidden
    output whole as levels, the other layers' outputs for ``rows``
    consecutive rows as levels; all in host memory."""

    def __init__(self, rng: np.random.Generator, forwards: int, rows: int,
                 a_bits: int):
        self.rng = rng
        self.forwards = forwards
        self.rows = rows
        self.n_a = (1 << a_bits) - 1
        self.seen = 0
        self.kept: list[dict] = []
        self.keep_all = False
        self.round = -1
        self.open = True
        self._active = None
        self._last = None

    def _host(self, t: torch.Tensor, levels: bool) -> torch.Tensor:
        """``t`` (its levels, in float16, where ``levels``) in host memory;
        from a card through pinned memory, enqueued on the stream."""
        if levels:
            t = (t * self.n_a).round_().to(torch.float16)
        if t.device.type != "cuda":
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out

    def begin(self, x: torch.Tensor) -> None:
        if not self.open:
            return
        self.seen += 1
        if self.keep_all or len(self.kept) < self.forwards:
            slot = len(self.kept)
        elif self.rng.random() < self.forwards / self.seen:
            slot = int(self.rng.integers(0, self.forwards))
        else:
            return
        n = min(self.rows, x.shape[0])
        at = int(self.rng.integers(0, x.shape[0] - n + 1))
        self._active = dict(slot=slot, round=self.round,
                            rows=slice(at, at + n), x=self._host(x, False),
                            layers=[], last_hidden=None)

    def layer(self, out: torch.Tensor) -> None:
        a = self._active
        if a is not None:
            a["layers"].append(self._host(out[a["rows"]], True))
            self._last = out

    def end(self) -> None:
        a, self._active = self._active, None
        if a is None:
            return
        if self._last is not None:
            a["last_hidden"] = self._host(self._last, True)
        self._last = None
        slot = a.pop("slot")
        if slot == len(self.kept):
            self.kept.append(a)
        else:
            self.kept[slot] = a

    def reset(self) -> None:
        """Drop what was kept (the warm-up's captures) and start counting."""
        self.kept, self.seen, self.keep_all = [], 0, False


@contextlib.contextmanager
def observe_layers(capture: Capture):
    """Route each call of the program's per-layer norm through ``capture``."""
    import repro_torch.models.cnn as cnn

    orig = cnn._norm_act

    def observed(*args, **kwargs):
        out = orig(*args, **kwargs)
        capture.layer(out)
        return out

    cnn._norm_act = observed
    try:
        yield
    finally:
        cnn._norm_act = orig


def match_rows(x: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Each row's index in ``pool`` (equal bit for bit), else -1."""
    flat = pool.reshape(pool.shape[0], -1)
    xr = x.to(pool.device).reshape(x.shape[0], -1)
    hit = (xr[:, None, :16] == flat[None, :, :16]).all(-1)
    cand = hit.int().argmax(1)
    ok = (hit.sum(1) == 1) & (flat[cand] == xr).all(1)
    return torch.where(ok, cand, torch.full_like(cand, -1)).long()


def compare(ref, params: list[dict], cfg: dict, kept: list[dict],
            pool: torch.Tensor, block: int = BLOCK) -> dict:
    """The numbers of :data:`NUMBERS` but ``missing`` over the kept
    forwards.  Each kept dict holds ``x`` (the staged batch),
    ``last_hidden`` (the last hidden layer's levels, every row), ``rows``
    (a slice) and ``layers`` (each hidden layer's levels on those rows),
    ``pool_idx`` (each row's image, -1 where none) and ``served`` (each
    row's served answer, NaN where none).  ``ref`` is the configuration's
    reference module; it runs ``block`` rows at a time."""
    layers = ref.network(cfg)
    n_a = (1 << cfg["a_bits"]) - 1
    dev = pool.device
    flips = np.zeros(len(layers) - 1)
    total = np.zeros(len(layers) - 1)
    chain = chain_total = 0
    gap, unmatched = 0.0, 0
    with ref.no_tf32():
        for c in kept:
            if len(c["layers"]) != len(layers) - 1:
                raise RuntimeError(
                    f"the program's per-layer norm ran {len(c['layers'])} "
                    f"times in a forward of {len(layers) - 1} hidden layers")
            served, idx = c["served"].to(dev), c["pool_idx"].to(dev)
            ok = (idx >= 0) & ~torch.isnan(served).any(1)
            unmatched += int((~ok).sum())
            if not bool(ok.any()):
                continue
            last = c["last_hidden"].to(dev)[ok]
            want = []
            for at in range(0, len(last), block):
                part = slice(at, at + block)
                # the answers, from the program's last hidden state
                h = (last[part].float() / n_a).permute(0, 3, 1, 2)
                want.append(ref.layer_step(params[-1], layers[-1], h, cfg,
                                           last=True).mean(dim=(2, 3)))
                # the whole chain, from the images alone
                hidden, _ = ref.states(params, pool[idx[ok][part]], cfg)
                chain += int((torch.round(hidden[-1] * n_a)
                              != last[part].float()).sum())
                chain_total += hidden[-1].numel()
            want = torch.cat(want)
            d = (served[ok] - want).abs().max() / want.abs().max()
            gap = max(gap, float(d) if torch.isfinite(d) else float("inf"))
            # the kept rows, layer by layer from the benchmark's image
            rows = ok[c["rows"]]
            h = pool[idx[c["rows"]][rows]].permute(0, 3, 1, 2)
            for i, layer in enumerate(layers[:-1]):
                y = ref.layer_step(params[i], layer, h, cfg, last=False)
                got = (c["layers"][i].to(dev)[rows].float()
                       .permute(0, 3, 1, 2))
                flips[i] += int((got != torch.round(y * n_a)).sum())
                total[i] += y.numel()
                h = got / n_a
                h = ref.pool(h) if layer.pool else h
    shares = flips / np.maximum(total, 1)
    return dict(level_flips=float(shares.max()),
                chain_flips=chain / max(chain_total, 1), logit_gap=gap,
                unmatched=unmatched, flips_by_layer=shares.tolist())


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)

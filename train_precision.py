"""How far the card's and the CPU's float32 training step sit from float64.

The paper's svhn CNN at width 64, W1A4, batch 32 (chip_smoke's ``TRAIN``
model and first batch), one step, layer by layer on the CPU's float32
inputs and output gradients.  For every layer it prints, relative to the
float64 value's max: each gradient leaf on the card (the port's training
conv, whose weight gradient is one GEMM over im2col patches), on the card
through cuDNN's own weight gradient, and on the CPU; and the pre-rounding
activation (conv, bias, batch norm, clip) on the card and on the CPU.
cuDNN runs in deterministic mode, as the bit-identical trainers run it.

  python3 train_precision.py            # on a machine with a CUDA card

Prints the card's name and power limit, then one ``PRECISION`` JSON line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core import conv_lowering  # noqa: E402
from repro_torch.core.quant import W1A4  # noqa: E402
from repro_torch.data.synthetic import svhn_like  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.train.intermittent import deterministic_algorithms  # noqa: E402

CHANNELS, BATCH = 64, 32


@contextlib.contextmanager
def cudnn_weight_grad():
    """The training conv through ``F.conv2d``'s own backward (cuDNN's
    weight gradient) for the duration."""
    saved = conv_lowering.ConvGemmWeightGrad.apply
    conv_lowering.ConvGemmWeightGrad.apply = (
        lambda x, w, stride: F.conv2d(x, w, stride=stride))
    try:
        yield
    finally:
        conv_lowering.ConvGemmWeightGrad.apply = saved


def layer_grads(spec, i, p, hin, up, device, dtype) -> dict:
    last = i == len(spec) - 1
    p = {k: v.detach().to(device, dtype).requires_grad_() for k, v in p.items()}
    hin = hin.detach().to(device, dtype).requires_grad_(i > 0)
    out = cnn.cnn_layer(p, spec[i], hin, W1A4, last)
    leaves = list(p.values()) + ([hin] if i else [])
    gs = torch.autograd.grad(out, leaves, up.to(device, dtype),
                             allow_unused=True)
    gs = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves, gs)]
    return {k: g.detach().double().cpu()
            for k, g in zip(list(p) + (["input"] if i else []), gs)}


def acts(spec, i, p, hin, device, dtype) -> torch.Tensor:
    fp = dataclasses.replace(W1A4, engine="fp")
    p = {k: v.detach().to(device, dtype) for k, v in p.items()}
    with torch.no_grad():
        pre = cnn.conv_bias(p, spec[i], hin.detach().to(device, dtype), W1A4)
        return cnn._norm_act(pre, p["g"], p["beta"], fp, spec[i].role,
                             "train").double().cpu()


def main() -> int:
    if not torch.cuda.is_available():
        print("train_precision: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    spec = cnn.svhn_cnn_spec(CHANNELS)
    last = len(spec) - 1
    params = cnn.init_cnn(torch.Generator(device="cuda").manual_seed(0),
                          spec)
    x, y = svhn_like(BATCH, seed=0)
    # the CPU's float32 chain: each layer's input and output gradient
    host = [{k: v.detach().cpu().requires_grad_() for k, v in p.items()}
            for p in params]
    ins, outs, h = [], [], torch.from_numpy(x)
    for i, (p, s) in enumerate(zip(host, spec)):
        h = h.detach().requires_grad_(i > 0)
        ins.append(h)
        h = cnn.cnn_layer(p, s, h, W1A4, i == last)
        outs.append(h)
    loss, _ = cnn.xent(torch.mean(outs[-1], dim=(1, 2)),
                       torch.from_numpy(y))
    ups = [None] * len(spec)
    ups[last], = torch.autograd.grad(loss, outs[-1])
    for i in range(last, 0, -1):
        ups[i - 1], = torch.autograd.grad(outs[i], ins[i], ups[i])

    rows = []
    with deterministic_algorithms():
        for i in range(len(spec)):
            args = (spec, i, host[i], ins[i], ups[i])
            exact = layer_grads(*args, "cpu", torch.float64)
            sides = dict(card=layer_grads(*args, "cuda", torch.float32),
                         cpu=layer_grads(*args, "cpu", torch.float32))
            with cudnn_weight_grad():
                sides["card_cudnn_wgrad"] = layer_grads(*args, "cuda",
                                                        torch.float32)
            for k, ref in exact.items():
                if k == "b" and i < last:    # exact gradient zero
                    continue
                scale = float(ref.abs().max())
                if scale == 0.0:
                    continue
                rows.append(dict(layer=i, leaf=k, **{
                    side: float((g[k] - ref).abs().max()) / scale
                    for side, g in sides.items()}))
            if i < last:
                a64 = acts(spec, i, host[i], ins[i], "cpu", torch.float64)
                scale = float(a64.abs().max())
                rows.append(dict(layer=i, leaf="activation", **{
                    side: float((acts(spec, i, host[i], ins[i], dev,
                                      torch.float32) - a64).abs().max())
                    / scale
                    for side, dev in (("card", "cuda"), ("cpu", "cpu"))}))
    print("PRECISION " + json.dumps(dict(
        model=f"svhn_cnn_spec({CHANNELS})", quant="w1a4", batch=BATCH,
        torch=torch.__version__, cudnn=torch.backends.cudnn.version(),
        rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark's fixed arithmetic: the published H100 peaks, each port
kernel's least time (its roofline bound) from the layer shapes that the
network and the batch give, the network's multiply-accumulates, the
labels of the program's device kernels, and a window's end-to-end metrics.

The peaks and :func:`bound_ms` are frozen copies of ``chip_smoke.py``'s;
:func:`count_macs` of ``repro_torch.models.cnn.count_macs``;
:func:`kernel_label` of ``chip_smoke._kernel_label``.  Nothing here reads
the program: a layer's work is the same whichever engine serves it.
"""
from __future__ import annotations

import dataclasses
import math

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12
# b1 AND + popcount: not in the H100 data sheet; 8x the int8 rate (the
# A100 data sheet's ratio), counted as 2 operations a bit product, so a
# faster AND kernel cannot read over 100%
PEAK_B1_OPS = 8 * PEAK_INT8_OPS

# the program's device kernels, by the name their launches carry
PORT_KERNELS = ("fused_qgemm", "conv_implicit", "attn_flash", "attn_paged",
                "quantize_pack", "bitgemm_packed", "int8_matmul")
# the kernels one layer launches on each engine of the plan
ENGINE_KERNELS = {"implicit": ("conv_implicit",),
                  "fused": ("fused_qgemm",),
                  "faithful": ("quantize_pack", "bitgemm_packed")}


def bound_ms(ops: float, nbytes: float, fp32_flops: float = 0.0,
             bf16_flops: float = 0.0, b1_ops: float = 0.0) -> float:
    """Larger of bytes over the memory rate and the arithmetic at the
    published rates, in ms."""
    t_ops = (ops / PEAK_INT8_OPS + fp32_flops / PEAK_FP32_FLOPS
             + bf16_flops / PEAK_BF16_FLOPS + b1_ops / PEAK_B1_OPS) * 1e3
    return max(t_ops, nbytes / PEAK_BYTES * 1e3)


def kernel_label(name: str) -> str:
    """The port kernel a device kernel belongs to, else its name cut to 70
    characters."""
    for k in PORT_KERNELS:
        if f"{k}_" in name and "_kernel" in name:
            return k
    return name[:70]


@dataclasses.dataclass(frozen=True)
class Shape:
    """One layer at one batch: the image in, the GEMM it is (M = B.OH.OW,
    K = k.k.cin, N = cout)."""
    batch: int
    in_h: int
    in_w: int
    cin: int
    k: int
    out_h: int
    out_w: int
    cout: int

    @property
    def m(self) -> int:
        return self.batch * self.out_h * self.out_w

    @property
    def kdim(self) -> int:
        return self.k * self.k * self.cin

    @property
    def macs(self) -> int:
        return self.m * self.kdim * self.cout


def _out_side(side: int, k: int, stride: int, valid: bool) -> int:
    """A conv's output side: SAME gives ceil(side / stride), VALID
    (side - k) // stride + 1 (``core.conv_lowering._out_hw``)."""
    if valid:
        return max((side - k) // stride + 1, 1)
    return -(-side // stride)


def layer_shapes(layers, img_hw: int, batch: int) -> list[Shape]:
    """Each layer's shape as the forward traces it
    (``core.plan._plan_cnn_layers``): SAME padding at the layer's stride,
    VALID for 1x1 kernels and ``fc`` layers, an ``fc`` layer's input
    resized to k x k, and a 2x2 pool after the layers that pool.
    ``layers``: the reference's description, each with ``cin``, ``cout``,
    ``k``, ``stride``, ``pool`` and ``fc``."""
    h, out = img_hw, []
    for l in layers:
        if l.fc and l.k > 1:
            h = l.k
        oh = _out_side(h, l.k, l.stride, valid=l.fc or l.k == 1)
        out.append(Shape(batch, h, h, l.cin, l.k, oh, oh, l.cout))
        h = max(oh // 2, 1) if l.pool else oh
    return out


def count_macs(layers, img: int) -> int:
    """Multiply-accumulates of one image (``models.cnn.count_macs``)."""
    h, total = img, 0
    for l in layers:
        oh = 1 if l.fc else max(-(-h // l.stride), 1)
        total += oh * oh * l.k * l.k * l.cin * l.cout
        h = oh
        if l.pool:
            h = max(h // 2, 1)
    return total


def kernel_work(kernel: str, s: Shape, a_bits: int, w_bits: int) -> dict:
    """A call's operations and bytes, each input read once and each output
    written once, at the layer's shape."""
    words = -(-s.kdim // 32)
    if kernel == "conv_implicit":       # levels in, float32 out
        return dict(ops=2.0 * s.m * s.kdim * s.cout + s.m * s.kdim,
                    nbytes=s.batch * s.in_h * s.in_w * s.cin
                    + s.kdim * s.cout + 4 * s.m * s.cout)
    if kernel == "fused_qgemm":
        return dict(ops=2.0 * s.m * s.kdim * s.cout + s.m * s.kdim,
                    nbytes=s.m * s.kdim + s.kdim * s.cout + 4 * s.m * s.cout)
    if kernel == "quantize_pack":       # (M, K) levels in, planes out
        return dict(ops=0.0, nbytes=s.m * s.kdim + 4 * a_bits * s.m * words)
    if kernel == "bitgemm_packed":      # planes in, int32 out
        return dict(b1_ops=2.0 * s.m * s.cout * s.kdim * a_bits * w_bits,
                    ops=0.0,
                    nbytes=4 * (a_bits * s.m * words + w_bits * s.cout * words
                                + s.m * s.cout))
    raise ValueError(f"no work formula for kernel {kernel!r}")


def kernel_bound_ms(kernel: str, s: Shape, a_bits: int, w_bits: int) -> float:
    return bound_ms(**kernel_work(kernel, s, a_bits, w_bits))


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]


def end_to_end(latency_s, wall_s: float, setup_s: float,
               energy_j: float | None) -> dict:
    """The end-to-end metrics of a window, ``name -> (value, unit)``: the
    images completed (one a latency) over the window's wall seconds, the
    95th percentile of every latency, the set-up seconds, and, where the
    cards' energy over the window is known, images per joule."""
    images = len(latency_s)
    out = dict(images_per_s=(images / wall_s, "images/s"),
               p95_ms=(1e3 * percentile(latency_s, 95), "ms"),
               setup_s=(setup_s, "s"))
    if energy_j is not None and energy_j > 0:
        out["images_per_J"] = (images / energy_j, "images/J")
    return out


def kernel_roofline(ctx: dict, kernel: str):
    """``kernel``'s share of its roofline in the traced slice, in %: the
    bounds of its calls over their device time.  The layers it serves are
    those whose engine launches it; each call's bound is its layer's at
    the replica's batch.  None where the slice holds no call of it."""
    prof = ctx["profile"]
    if not prof:
        return None
    sec = calls = 0
    for name, (s, n) in prof["by_kernel"].items():
        if kernel_label(name) == kernel:
            sec, calls = sec + s, calls + n
    cfg = ctx["cfg"]
    shapes = layer_shapes(ctx["layers"], cfg["img_hw"], ctx["replica_batch"])
    served = [s for s, (eng, fp) in zip(shapes, ctx["plan_layers"])
              if not fp and kernel in ENGINE_KERNELS.get(eng, ())]
    if not calls or not served:
        return None
    per_call_ms = sum(kernel_bound_ms(kernel, s, cfg["a_bits"], cfg["w_bits"])
                      for s in served) / len(served)
    return 100.0 * calls * per_call_ms * 1e-3 / sec

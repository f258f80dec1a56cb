"""The served CNN's per-sample norm and bounded activation in one kernel.

No Pallas kernel: the JAX package's norm-act (``repro/models/cnn.py``,
``_norm_act``) is ``jnp`` code.  The CUDA kernel is ``csrc/norm_act.cu``;
its source note says what bounds it on an H100 and how it keeps each
sample's slab on chip.  :func:`norm_act` is the wrapper: a CPU or meta
tensor takes :func:`norm_act_plain`, a CUDA tensor launches the kernel or
raises.  :func:`plan_for` chooses the kernel's path and its cluster from
the map's shape alone; each call counts the path it took in
``launch.trace.TRACER.counters`` (``kernels.norm_act.resident`` or
``kernels.norm_act.two_pass``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.quant import clip01, quantize_activation
from repro_torch.launch.trace import TRACER
from . import _lib

NAME = "norm_act"
EPS = 1e-5
# a block's most shared memory on an H100 (227 KB), threads a block, and
# blocks a cluster (the portable size)
SMEM_LIMIT = 232448
MAX_THREADS = 1024
MAX_CLUSTER = 8
# 16-byte vectors a thread
VECS_PER_THREAD = 12
# the two-pass path's chunk: this many 16-byte vectors a thread
TWO_PASS_VECS = 4


class NormActPlan(NamedTuple):
    """One call's launch (``csrc/norm_act.cu``, ``norm_act_launch``)."""
    path: str         # "resident" (one read) or "two_pass" (two reads)
    chunks: int       # slices a sample: the cluster on the resident path
    vec: int          # floats a copy: 4 (16 bytes) or 1
    threads: int      # a block's; vec * threads spans whole lcm(vec, C)
    chunk_vec: int    # vectors a slice: the same multiple
    smem_bytes: int   # a block's dynamic shared memory (STATS on two-pass)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _smem(vec: int, threads: int, chunk_vec: int, c: int) -> int:
    """The slice, two rows of partials a thread, a mean and a rsqrt a
    channel: the kernel's layout."""
    return 4 * (vec * chunk_vec + 2 * vec * threads + 2 * c)


@functools.lru_cache(maxsize=256)
def plan_for(h: int, w: int, c: int) -> NormActPlan:
    """The launch for an (H, W, C) map, from its shape alone.  A sample is
    resident in the fewest blocks, at most MAX_CLUSTER (a cluster), whose
    slices and reduction scratch fit a block's shared memory; a larger
    sample takes the two-pass path.  A thread's vectors lie a whole
    multiple of lcm(vec, C) floats apart, so it always meets the same
    channels; where C needs more than a block's threads for that
    (lcm(vec, C) / vec > 1024), the map is refused."""
    slab = h * w * c
    if slab <= 0:
        raise ValueError(f"norm_act: empty map ({h}, {w}, {c})")
    vec = 4 if slab % 4 == 0 else 1
    lanes = math.lcm(vec, c) // vec       # threads, and slices, span these
    if lanes > MAX_THREADS:
        raise ValueError(f"norm_act: C = {c} needs {lanes} threads a block "
                         f"to keep each thread's channels fixed "
                         f"(> {MAX_THREADS})")
    step = math.lcm(32, lanes)            # whole warps where it can
    step = step if step <= MAX_THREADS else lanes
    n_vec = slab // vec

    def threads_for(n: int) -> int:      # VECS_PER_THREAD vectors each
        return max(step, min(MAX_THREADS, _ceil(n, VECS_PER_THREAD))
                   // step * step)

    for chunks in range(1, MAX_CLUSTER + 1):
        chunk_vec = _ceil(_ceil(n_vec, chunks), lanes) * lanes
        if (chunks - 1) * chunk_vec >= n_vec:    # a slice left empty
            continue
        threads = threads_for(chunk_vec)
        smem = _smem(vec, threads, chunk_vec, c)
        if smem <= SMEM_LIMIT:
            return NormActPlan("resident", chunks, vec, threads, chunk_vec,
                               smem)
    threads = MAX_THREADS // step * step
    chunk_vec = TWO_PASS_VECS * threads
    return NormActPlan("two_pass", _ceil(n_vec, chunk_vec), vec, threads,
                       chunk_vec, _smem(vec, threads, chunk_vec, c))


def groups_for(batch: int, fit: int) -> int:
    """The resident grid's clusters for ``batch`` samples where ``fit``
    clusters fit the card at once: as few rounds of samples as ``fit``
    allows, the samples spread evenly over them."""
    return _ceil(batch, _ceil(batch, fit))


@functools.lru_cache(maxsize=256)
def _fit(device: int, plan: NormActPlan) -> int:
    """The resident clusters of ``plan`` that fit card ``device`` at once
    (``norm_act_fit``; the current device is ``device``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fit = ctypes.c_int(0)
    err = _lib.launcher(NAME, [i, i, i, i, p], suffix="fit")(
        plan.vec, plan.threads, plan.chunks, plan.smem_bytes,
        ctypes.byref(fit))
    _lib.check_launch(NAME, err)
    if fit.value < 1:
        raise RuntimeError(f"norm_act: no cluster of {plan} fits the card")
    return fit.value


def norm_act_plain(x: torch.Tensor, g, beta, bias=None, bits: int = 32,
                   dims=(1, 2)) -> torch.Tensor:
    """Plain PyTorch version: ``x + bias``, then per-channel statistics
    over ``dims`` (the sample's H, W when serving; (B, H, W) in training),
    population variance, normalize, scale, shift, clip to [0, 1], and the
    DoReFa activation quantizer at ``bits`` (none at 32 or more)."""
    if bias is not None:
        x = x + bias
    mu = torch.mean(x, dim=dims, keepdim=True)
    var = torch.var(x, dim=dims, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + EPS) * g + beta
    return quantize_activation(clip01(x), bits)


def _check(x, g, beta, bias, bits) -> None:
    if x.ndim != 4:
        raise ValueError(f"norm_act: needs x (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    c = x.shape[3]
    for name, v in (("g", g), ("beta", beta), ("bias", bias)):
        if v is None and name == "bias":
            continue
        if not isinstance(v, torch.Tensor) or v.numel() != c:
            raise ValueError(f"norm_act: {name} needs {c} values, one a "
                             f"channel")
        if v.device != x.device or v.dtype != torch.float32:
            raise ValueError(f"norm_act: {name} must be float32 on "
                             f"{x.device}")
        if not v.is_contiguous():
            raise ValueError(f"norm_act: {name} must be contiguous")
    if x.dtype != torch.float32:
        raise TypeError(f"norm_act: needs float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("norm_act: x must be contiguous")
    if bits < 1:
        raise ValueError(f"norm_act: bits must be at least 1, got {bits}")


@_lib.counted(NAME, lambda *a, **k: 0.0)   # elementwise: no GEMM flops
def norm_act(x: torch.Tensor, g: torch.Tensor, beta: torch.Tensor,
             bias: torch.Tensor | None, bits: int) -> torch.Tensor:
    """(B, H, W, C) float32 conv output -> its per-sample norm-act,
    :func:`norm_act_plain` with ``dims=(1, 2)``.  On the device: one
    ``torch.empty`` and one launch (resident) or two (two-pass, with a
    ``torch.empty`` of statistics)."""
    _check(x, g, beta, bias, bits)
    if x.device.type in _lib.PLAIN_DEVICES:
        return norm_act_plain(x, g, beta, bias, bits)
    if x.device.type != "cuda":
        raise ValueError(f"norm_act: unsupported device {x.device}")
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    plan = plan_for(h, w, c)
    if plan.vec == 4 and x.data_ptr() % 16:
        raise ValueError("norm_act: x must start on a 16-byte boundary")
    two_pass = plan.path == "two_pass"
    stats = (torch.empty((b, plan.chunks, c, 2), dtype=torch.float32,
                         device=x.device) if two_pass else None)
    n_levels = float((1 << bits) - 1) if bits < 32 else 0.0
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    launch = _lib.launcher(NAME, [p] * 6 + [ll] * 3 + [i] * 7 + [f, p])
    with torch.cuda.device(x.device):
        groups = 0 if two_pass else groups_for(
            b, _fit(torch.cuda.current_device(), plan))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), None if bias is None else bias.data_ptr(),
                     g.data_ptr(), beta.data_ptr(), out.data_ptr(),
                     None if stats is None else stats.data_ptr(),
                     b, h * w * c, groups, c, plan.vec, plan.threads,
                     plan.chunks, plan.chunk_vec, int(two_pass),
                     plan.smem_bytes, n_levels, stream)
    _lib.check_launch(NAME, err)
    _lib.LAUNCHES[NAME] += 1
    TRACER.count(f"kernels.norm_act.{plan.path}")
    return out

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which makes the script exit nonzero when it fails:

1. the card's name and power limit (``nvidia-smi``); TF32 off;
2. build every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``
   (one process per source, all at once) and print ``-Xptxas -v``;
3. kernels: at every batch-8 shape the svhn and AlexNet serve paths give
   each kernel, hold the kernel against its plain PyTorch version on the
   card (pinned-scale accumulators and full-epilogue outputs exactly
   equal) and time kernel, plain version and a library yardstick beside
   the card's bound (``F.conv2d`` fp32 for ``conv_implicit``, with
   ``torch._int_mm`` on the same GEMM view as ``int_mm_ms``), count each
   call's device operations (``device_ops_per_call``: one for both) and
   carry their time before the tensor-core redesign (``prev_ms``, a
   constant, as for the attention rows below);
   the bit-plane kernels (``quantize_pack`` float-in and levels-in,
   ``bitgemm_packed`` at W1A1 and W1A4, ``int8_matmul`` on the W1A8
   nibble groups and on one signed case) at svhn's six quantized layers
   and AlexNet's (fc5/fc6 for ``int8_matmul``) at batch 8, held to their
   plain versions with ``torch.equal`` and timed beside their bound,
   their plain version and ``torch._int_mm`` on the levels (the GEMMs)
   or a ``Tensor.copy_`` of the input (``quantize_pack``: ``copy_ms``);
   the three kernels' rows count each call's device operations (one for
   each) and carry their time before the redesign (``prev_ms``, a
   constant); ``int8_matmul`` is also held and timed at SmolLM-360M's
   four decode GEMMs (8 rows) beside ``torch._int_mm`` at the LM's 24
   padded rows, outside the main path and the ``kernels`` line's sums;
   the LM kernels (``attn_flash`` at the bucket prefill's shape and one
   window shape, ``attn_paged`` at a decode step and a prefill chunk) are
   held against their plain versions within 1e-5 x max|v| on float32
   inputs (and one bfloat16 rounding on bfloat16 ones, in max and in each
   element against the plain float32 result: ``bf16_elementwise_worst``)
   and timed in bfloat16, the main path's type; the rows also carry the
   time of the kernels before their redesign (``prev_ms``, a constant of
   this script, not measured by the run and kept out of the ``kernels``
   line);
   each row counts the device operations of one call
   (``device_ops_per_call``: at most 3 for ``attn_flash``, 2 for
   ``attn_paged``), and ``attn_paged`` is also held and timed at a decode
   step over 128-page tables (2048 tokens a slot; not a main-path shape,
   so outside the ``kernels`` line's sums);
4. CNN main path: through ``build -> compile(target="cuda") ->
   serve(max_batch=8)`` at W1A4 and W1A8, full-width svhn answers a
   16-request correctness set three times over (logits exactly equal to
   the plain versions', alone vs batched within a tolerance), then serves
   a closed loop of 32 outstanding requests for a 4 s window, the
   serving measurement; full AlexNet runs one 224x224 W1A8 forward at
   batch 8 with the same checks; the launch counts are checked;
4b. the faithful and int8 engines' main path: the same svhn through
   ``build -> compile(target="cuda") -> serve(max_batch=8)`` with
   ``engine="faithful"`` at W1A1 and W1A4 and ``engine="int8"`` at W1A8
   answers the 16-request set three times; its logits equal the plain
   versions' and the default engines' (fused/implicit) exactly, alone vs
   batched within the tolerance; 4 s serving windows for faithful W1A1
   and int8 W1A8 (and, outside the counted run, default W1A1); AlexNet
   W1A1 faithful at batch 8 (fc5's output and the logits equal the
   default engines' exactly); the launch counts are checked (6
   ``quantize_pack`` + 6 ``bitgemm_packed`` per faithful dispatch, 12
   ``int8_matmul`` per int8 dispatch, no ``fused_qgemm`` or
   ``conv_implicit``); then ``quant_dense_kernel`` on AlexNet fc5's shape,
   both paths equal to each other and to the plain versions, with 1
   ``quantize_pack`` and 1 ``bitgemm_packed`` or ``int8_matmul`` launch;
5. LM main path: full-width SmolLM-360M W1A8 (random weights, seed 2)
   serves two 2048-token prompts x 16 new tokens through ``ServeEngine``
   + ``LMRunner`` (flash prefill) and 16 mixed requests through
   ``ContinuousLMEngine`` (8 slots, pages of 16; paged attention); the
   launch counts are checked, the tokens held against the same paths on
   the plain versions and continuous against alone (a token may differ
   only where the plain run's top-2 logit margin is under LM_MARGIN_TOL),
   and one decode step of each engine is profiled;
5b. resilience (power intermittency, the paper's second claim), one
   ``RESILIENCE`` line: full-width svhn W1A8 compiled on the card, saved
   and reloaded through ``api.load`` (logits equal bit for bit; compile
   and load ms on the card feed ``plan_resume_study``), and
   ``launch.plan_smoke --device cuda`` in fresh processes (its compile and
   load, each a process's first, feed the study too); the W1A8 plan
   served by ``ResilientServeEngine`` with a faithful W1A1 fallback under
   a scripted fault plan (a staging corruption, a power loss at a
   dispatch, a device drop that trips the degrade policy): every answer
   equals the plain engine's on its own plan bit for bit, the counters
   match the schedule and ``fused_qgemm``, ``conv_implicit``,
   ``quantize_pack`` and ``bitgemm_packed`` launch; full-width
   SmolLM-360M through ``EpochLMRunner`` with decode epoch checkpoints,
   killed by a power loss mid-decode: the resumed tokens equal the
   fault-free run's (bytes and seconds per commit printed); and
   ``ContinuousLMEngine`` with ``checkpoint_dir`` and a scripted power
   loss: every result equals the fault-free run's, ``attn_paged``
   launches;
5c. execution plans, one ``PLAN`` line: ``compile(target="cuda",
   autotune=True)`` for svhn (40x40, W1A1/W1A4/W1A8, batch hints 1 and 8)
   and AlexNet (224x224, W1A1/W1A8, batch hint 8) times every layer's
   candidate engines on the card as served (each layer's microseconds,
   verdict and ``engine_source`` printed); each autotuned plan's logits
   (AlexNet: fc5's output) equal the heuristic plan's bit for bit; each
   plan is saved, the autotune state cleared and the plan reloaded with
   zero calls to ``_time_engine`` and equal engines; a 4 s serving window
   of the autotuned svhn W1A1 plan beside the heuristic one (a report,
   not a gate); the SmolLM-360M W1A8 LM plan (seed 2, bf16) through
   ``api.build(cfg, params=...).compile(prompt_len=2048, batch_hints=(2,),
   page_size=16, kv_pages=...)``: the dense table's four (K, N) keys,
   ``flash`` at the prefill and ``paged`` at the decode geometry, its
   served tokens held to the plan-free bucket run of phase 5 before and
   after a save and ``api.load``, 32 ``attn_flash`` launches per bucket
   prefill, and ``compile_lm(autotune=True)``'s ``f32dot``/``int8`` times
   at the four shapes; every CNN kernel and ``attn_flash`` launch;
6. one JSON line listing the kernels, then the contract's last line.

``--kernels-only`` stops after phase 3 (a quick first check of a kernel).
The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12    # non-tensor-core float32
PEAK_BF16_FLOPS = 989e12   # bf16 dense tensor cores (attention's P @ V)
# b1 AND + popcount (bitgemm_packed's mma .b1 .and.popc): not in the data
# sheet; mma.sync issues it at the u8 instruction rate with 8x the K, so
# 8x the int8 peak, counted as 2 operations (AND, add) a bit product
PEAK_B1_OPS = 8 * PEAK_INT8_OPS
# alone vs batched only: a request's logits may move by level flips at
# exact .5 boundaries when the library reductions and convolutions around
# the kernels change summation order with the batch size; the JAX
# reference drifts ~4% of max|logit| between its own jit and eager runs
# (tests/test_torch_cnn.py), so twice that is the tolerance here.  The
# kernels against their plain versions run the same float ops at the same
# batch and are held exactly.
LOGIT_TOL_FRAC = 0.1
# sm_90 issues 16 32-bit population counts per SM per clock (CUDA C++
# Programming Guide, arithmetic instruction throughput): with one AND and
# one add beside each, the floor of the AND + popcount dataflow on the
# CUDA cores
POPC_PER_SM_CLOCK = 16
# the bit-plane engines' main path: (bit widths, engine), and the ones
# whose 4 s serving window is measured
BITPLANE_PATHS = (("w1a1", "faithful"), ("w1a4", "faithful"),
                  ("w1a8", "int8"))
BITPLANE_WINDOWS = ("w1a1 faithful", "w1a8 int8")
# ~1 ms of device time at H100 clocks: longer than the host needs to
# enqueue one launch of a kernel or of its plain version
SLEEP_CYCLES = 2_000_000
# rounds of the 16-request svhn correctness set in the counted run
SERVE_ROUNDS = 3
# the svhn serving measurement: a closed loop that keeps CONCURRENCY
# requests outstanding (four full buckets of 8) for WINDOW_S seconds
WINDOW_S = 4.0
CONCURRENCY = 32
# LM main path: the bucket engine's batch, prompt and horizon; the
# continuous engine's slots, page size, pages and request mix
LM_BATCH, LM_PROMPT, LM_NEW = 2, 2048, 16
CONT_SLOTS, CONT_PAGE, CONT_PAGES, CONT_REQUESTS = 8, 16, 512, 16
CONT_PROMPTS, CONT_HORIZONS = (32, 256), (8, 32)
# a greedy token of a kernel run may differ from the plain run's only at
# a position whose plain top-2 logit margin is below this (logit units).
# SmolLM's random-weight logits have a standard deviation near 0.6; the
# kernels' float outputs differ from their plain versions by ~1e-7 relative,
# which 32 layers of bf16 rounding and 8-bit requantization can grow to
# level flips; 0.05 is an allowance of a few such flips' worth.
LM_MARGIN_TOL = 0.05
# the kernels against their plain versions: float32 logits are the same
# integers times the same scale, so only the order of exp and the sums
# differs; bfloat16 outputs add one rounding of the output
ATTN_TOL_F32, ATTN_TOL_BF16 = 1e-5, 2.0 ** -7   # x max|v|
# device operations one call of each attention wrapper may make (its
# kernels; no PyTorch op beside them), counted as the nodes of a CUDA graph
# captured from one call (_lib.count_device_ops)
ATTN_MAX_DEVICE_OPS = {"attn_flash": 3, "attn_paged": 2}
# each attention case's kernel ms before the kernels' redesign: constants
# from this script at the parent commit of the redesign (NVIDIA H100 80GB
# HBM3, 700.00 W), printed as ``prev_ms`` on the KERNEL rows and never
# measured by this run; the 128-page case did not exist then
ATTN_PREV_MS = {"bucket prefill": 1.039983993768692,
                "window 256": 0.2771487981081009,
                "decode step": 0.187896532813708,
                "prefill chunk": 0.2726954648892085}


PREV_MS_SOURCE = ("constant ATTN_PREV_MS: the kernels before their "
                  "redesign, not measured by this run")
# device operations one call of each CNN kernel may make: one launch
# (fused_qgemm's split-K combines inside it, through a cluster)
CNN_MAX_DEVICE_OPS = {"fused_qgemm": 1, "conv_implicit": 1}
# each CNN main-path shape's kernel ms at W1A8 before the redesign of
# conv_implicit and fused_qgemm for the tensor cores: constants from a run
# of this script on the __dp4a kernels (NVIDIA H100 80GB HBM3, 700.00 W),
# printed as ``prev_ms`` on the KERNEL rows and never measured by this run
CNN_PREV_MS = {"svhn conv1": 0.0315, "svhn conv2": 0.0562,
               "svhn conv3": 0.0307, "svhn conv4": 0.0448,
               "svhn conv5": 0.0525, "svhn conv6": 0.0119,
               "alexnet conv1": 0.1684, "alexnet conv2": 0.0793,
               "alexnet conv3": 0.1142, "alexnet conv4": 0.0727,
               "alexnet fc5": 0.2560, "alexnet fc6": 0.1156}
CNN_PREV_MS_SOURCE = ("constant CNN_PREV_MS: the __dp4a kernels before "
                      "their tensor-core redesign, not measured by this run")
# device operations one call of each bit-plane kernel may make: one launch
# (the GEMMs' split-K combines inside it, through a cluster; quantize_pack
# writes every word of its outputs, so no memset)
BIT_MAX_DEVICE_OPS = {"quantize_pack": 1, "bitgemm_packed": 1,
                      "int8_matmul": 1}
# each bit-plane GEMM row's kernel ms before the tensor-core redesign of
# bitgemm_packed (__popc on the CUDA cores) and int8_matmul (__dp4a):
# constants from a run of this script on those kernels (NVIDIA H100 80GB
# HBM3, 700.00 W, batch 8), printed as ``prev_ms`` on the KERNEL rows and
# never measured by this run
BIT_PREV_MS = {
    "bitgemm_packed svhn conv1 a1": 0.0148, "bitgemm_packed svhn conv2 a1": 0.0238,
    "bitgemm_packed svhn conv3 a1": 0.0179, "bitgemm_packed svhn conv4 a1": 0.0206,
    "bitgemm_packed svhn conv5 a1": 0.0294, "bitgemm_packed svhn conv6 a1": 0.0082,
    "bitgemm_packed svhn conv1 a4": 0.0382, "bitgemm_packed svhn conv2 a4": 0.0656,
    "bitgemm_packed svhn conv3 a4": 0.0372, "bitgemm_packed svhn conv4 a4": 0.0577,
    "bitgemm_packed svhn conv5 a4": 0.0649, "bitgemm_packed svhn conv6 a4": 0.0122,
    "bitgemm_packed alexnet conv1 a1": 0.0601,
    "bitgemm_packed alexnet conv2 a1": 0.0318,
    "bitgemm_packed alexnet conv3 a1": 0.0458,
    "bitgemm_packed alexnet conv4 a1": 0.0424,
    "bitgemm_packed alexnet fc5 a1": 0.0939,
    "bitgemm_packed alexnet fc6 a1": 0.0430,
    "int8_matmul svhn conv1": 0.0232, "int8_matmul svhn conv2": 0.0364,
    "int8_matmul svhn conv3": 0.0365, "int8_matmul svhn conv4": 0.0394,
    "int8_matmul svhn conv5": 0.0642, "int8_matmul svhn conv6": 0.0120,
    "int8_matmul alexnet fc5": 0.2469, "int8_matmul alexnet fc6": 0.1127}
BIT_PREV_MS_SOURCE = ("constant BIT_PREV_MS: the CUDA-core kernels before "
                      "their tensor-core redesign, not measured by this run")
# each quantize_pack row's kernel ms (4 bits, batch 8) before its redesign
# for Hopper (a warp per packed word, planes by __ballot_sync): constants
# from a run of this script on that kernel (NVIDIA H100 80GB HBM3, 700.00
# W), printed as ``prev_ms`` on the KERNEL rows and never measured by this
# run
QP_PREV_MS = {
    "quantize_pack svhn conv1 float in": 0.04320,
    "quantize_pack svhn conv1 levels in": 0.03760,
    "quantize_pack svhn conv2 float in": 0.04315,
    "quantize_pack svhn conv2 levels in": 0.03767,
    "quantize_pack svhn conv3 float in": 0.02431,
    "quantize_pack svhn conv3 levels in": 0.02159,
    "quantize_pack svhn conv4 float in": 0.02429,
    "quantize_pack svhn conv4 levels in": 0.02168,
    "quantize_pack svhn conv5 float in": 0.01504,
    "quantize_pack svhn conv5 levels in": 0.01364,
    "quantize_pack svhn conv6 float in": 0.00671,
    "quantize_pack svhn conv6 levels in": 0.00637,
    "quantize_pack alexnet conv1 float in": 0.08179,
    "quantize_pack alexnet conv1 levels in": 0.07102,
    "quantize_pack alexnet conv2 float in": 0.02407,
    "quantize_pack alexnet conv2 levels in": 0.02128,
    "quantize_pack alexnet conv3 float in": 0.03330,
    "quantize_pack alexnet conv3 levels in": 0.02913,
    "quantize_pack alexnet conv4 float in": 0.03325,
    "quantize_pack alexnet conv4 levels in": 0.02910,
    "quantize_pack alexnet fc5 float in": 0.00618,
    "quantize_pack alexnet fc5 levels in": 0.00595,
    "quantize_pack alexnet fc6 float in": 0.00596,
    "quantize_pack alexnet fc6 levels in": 0.00580}
QP_PREV_MS_SOURCE = ("constant QP_PREV_MS: the warp-per-word kernel before "
                     "its redesign, not measured by this run")
# SmolLM-360M's decode GEMMs (K, N) at 8 rows: q/o (960, 960), k/v (960,
# 320), gate/up (960, 2560), down (2560, 960).  The LM runs them on
# torch._int_mm (rows padded to 24, core/and_accum.centred_gemm_int);
# int8_matmul is held and timed there beside it, outside the main path
LM_INT8_GEMMS = ((960, 960), (960, 320), (960, 2560), (2560, 960))
LM_INT8_ROWS, LM_INT_MM_ROWS = 8, 24


# the resilience phase: svhn requests and the scripted fault schedule
# (per-site poll counts: the staging of bucket 0 is corrupted and restaged,
# bucket 1 loses power at its dispatch, bucket 2's device drops, which
# trips the policy: 2 kill-class faults in a window of 4)
RES_SVHN_REQUESTS = 32
RES_CNN_FAULTS = (("staging", 0, "staging_corruption"),
                  ("dispatch", 1, "power_loss"),
                  ("dispatch", 2, "device_drop"))
# the resumed LM decode: batch, prompt, horizon (16 decode steps in epochs
# of 4; one commit after prefill and one per epoch) and the kill point (the
# third decode epoch's gate)
RES_LM_BATCH, RES_LM_PROMPT, RES_LM_NEW, RES_LM_EPOCH = 2, 256, 17, 4
RES_LM_KILL = ("decode", 2, "power_loss")
# the continuous engine under a power loss: slots, pages, requests
RES_CONT_SLOTS, RES_CONT_PAGES, RES_CONT_REQUESTS = 4, 64, 6
RES_CONT_EPOCH, RES_CONT_KILL = 4, ("decode", 6, "power_loss")

# the plan phase: CNN autotune per model, batch hints and bit widths (svhn
# at 40x40, AlexNet at 224x224), and the LM plan's paged geometry: the
# page-table width of lm_main_path's continuous run
PLAN_SVHN_QUANTS, PLAN_ALEX_QUANTS = ("w1a1", "w1a4", "w1a8"), ("w1a1",
                                                                 "w1a8")
PLAN_SVHN_HINTS, PLAN_ALEX_HINTS = (1, 8), (8,)
PLAN_KV_PAGES = -(-(CONT_PROMPTS[1] + CONT_HORIZONS[1]) // CONT_PAGE)
# the kernels the plan phase must launch: every CNN kernel (each autotune
# candidate is timed as served) and the LM plan's flash prefill
PLAN_KERNELS = ("fused_qgemm", "conv_implicit", "quantize_pack",
                "bitgemm_packed", "int8_matmul", "attn_flash")

# a fresh interpreter's compile or load of the resilience phase's svhn W1A8
# plan (argv: "compile" | "load", the plan's base path): what a node back
# from a power loss pays; the params are drawn first, so both modes start
# timing with the CUDA context up
RES_COLD_PLAN = r"""
import json, sys, time, torch
from repro_torch import api
from repro_torch.core.quant import W1A8
from repro_torch.models.cnn import init_cnn, svhn_cnn_spec
mode, base = sys.argv[1:]
spec = svhn_cnn_spec()
params = init_cnn(torch.Generator(device="cuda").manual_seed(0), spec)
torch.cuda.synchronize()
t0 = time.perf_counter()
if mode == "compile":
    c = api.build(spec, W1A8, params=params, img_hw=40, name="svhn").compile(
        target="cuda", batch_hints=(1, 8))
else:
    c = api.load(base, quant=W1A8, model="svhn", backend="cuda",
                 device="cuda")
torch.cuda.synchronize()
print(json.dumps(dict(ms=1e3 * (time.perf_counter() - t0),
                      fingerprint=c.fingerprint())))
"""

class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, flush: torch.Tensor | None) -> float:
    """Mean device ms of ``fn`` over ``reps`` launches after warm-up, with
    CUDA events around each launch.  ``flush`` (larger than the 50 MB L2)
    is overwritten before each launch so it starts with a cold cache, and
    a device-side sleep keeps the card busy while the host enqueues the
    start event, the launch and the end event — so the events time the
    kernel, not the host's launch overhead."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bound_ms(ops: float, nbytes: float, fp32_flops: float = 0.0,
             bf16_flops: float = 0.0, b1_ops: float = 0.0
             ) -> tuple[float, str]:
    """Larger of bytes over the memory rate and the arithmetic: int8
    operations at the int8 tensor-core rate, plus float32 operations at the
    non-tensor float32 rate, plus bf16 operations at the bf16 tensor-core
    rate, plus b1 AND + popcount operations at the b1 rate."""
    t_ops = (ops / PEAK_INT8_OPS + fp32_flops / PEAK_FP32_FLOPS
             + bf16_flops / PEAK_BF16_FLOPS + b1_ops / PEAK_B1_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_shapes():
    """(model, layer, engine, geometry) of every quantized layer on the
    svhn and AlexNet serve paths at batch 8, from the compiled plans."""
    from repro_torch.core.plan import compile_model
    from repro_torch.core.quant import W1A8
    from repro_torch.models.cnn import alexnet_spec, svhn_cnn_spec

    rows = []
    for model, spec, hw in (("svhn", svhn_cnn_spec(), 40),
                            ("alexnet", alexnet_spec(), 224)):
        plan = compile_model(None, spec, W1A8, target="cuda",
                             batch_hints=(8,), img_hw=hw)
        rows += [(model, lp) for lp in plan.layers if not lp.fp]
    return rows


def kernel_phase(flush: torch.Tensor) -> dict:
    import torch.nn.functional as F

    from repro_torch.core.and_accum import epilogue_scales, level_gemm_exact
    from repro_torch.core.conv_lowering import im2col_sliced, pad_split
    from repro_torch.kernels import _lib
    from repro_torch.kernels.conv_implicit import (conv_implicit,
                                                   conv_implicit_plain)
    from repro_torch.kernels.fused_qgemm import fused_qgemm, fused_qgemm_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {"fused_qgemm": [], "conv_implicit": []}
    # what time_ms reads for a one-element kernel after the same L2 flush:
    # the floor under every kernel time below
    one = torch.zeros(1, device=dev)
    print("TIMER_FLOOR", json.dumps(dict(
        ms=time_ms(lambda: one.add_(1.0), 30, flush),
        ms_no_flush=time_ms(lambda: one.add_(1.0), 30, None))), flush=True)
    for model, lp in kernel_shapes():
        b = 8
        w_lv = torch.randint(0, 2, (lp.k, lp.cout), generator=gen,
                             dtype=torch.uint8, device=dev)
        for a_bits in (4, 8):
            n = (1 << a_bits) - 1
            pinned = (float(n), 0.0)
            check(tuple(map(float, epilogue_scales(a_bits, *pinned)))
                  == (1.0, 0.0), "pinned scales are not (1, 0)")
            full = (0.0421, 0.5)   # a 1-bit layer's 2*mean|w| and 1/2
            if lp.engine == "implicit":
                x = torch.randint(0, n + 1, (b, lp.in_h, lp.in_w, lp.cin),
                                  generator=gen, dtype=torch.uint8, device=dev)
                kw = dict(kh=lp.kh, kw=lp.kw, stride=lp.stride,
                          padding=lp.padding, a_bits=a_bits, w_bits=1)
                kern = lambda sc, x=x, kw=kw: conv_implicit(x, w_lv, *sc, **kw)
                plain = lambda sc, x=x, kw=kw: conv_implicit_plain(
                    x, w_lv, *sc, **kw)
                patches = im2col_sliced(x, lp.kh, lp.kw, lp.stride,
                                        lp.padding).reshape(-1, lp.k)
                acc = level_gemm_exact(patches, w_lv).reshape(
                    b, lp.out_h, lp.out_w, lp.cout)
                m = b * lp.out_h * lp.out_w
                nbytes = x.numel() + w_lv.numel() + 4 * m * lp.cout
                name = "conv_implicit"
            else:
                m = b * lp.out_h * lp.out_w
                x = torch.randint(0, n + 1, (m, lp.k), generator=gen,
                                  dtype=torch.uint8, device=dev)
                kern = lambda sc, x=x: fused_qgemm(
                    x, w_lv, *sc, a_bits=a_bits, w_bits=1, a_is_levels=True)
                plain = lambda sc, x=x: fused_qgemm_plain(
                    x, w_lv, *sc, a_bits=a_bits, w_bits=1, a_is_levels=True)
                acc = level_gemm_exact(x, w_lv)
                nbytes = x.numel() + w_lv.numel() + 4 * m * lp.cout
                name = "fused_qgemm"
            got = kern(pinned)
            torch.cuda.synchronize()
            check(torch.equal(got, acc.to(torch.float32)),
                  f"{name} {model} {lp.name} a{a_bits}: accumulator differs "
                  f"from the exact one")
            check(torch.equal(got, plain(pinned)),
                  f"{name} {model} {lp.name} a{a_bits}: pinned output differs")
            out, ref = kern(full), plain(full)
            err = (out - ref).abs().max().item()
            rel = ((out - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()
            # kernel and plain version round s*acc and t*rowsum alike, so
            # the full epilogue (rowsum included) must agree bit for bit
            check(torch.equal(out, ref),
                  f"{name} {model} {lp.name} a{a_bits}: full-epilogue output "
                  f"differs from the plain version (max abs {err})")
            row = dict(model=model, layer=lp.name, a_bits=a_bits,
                       shape=list(x.shape), k=lp.k, n=lp.cout,
                       max_abs_err=err, max_rel_err=rel)
            if a_bits == 8:  # time at the W1A8 operands
                ops = 2.0 * m * lp.k * lp.cout + m * lp.k
                row["ms"] = time_ms(lambda: kern(full), 30, flush)
                row["plain_ms"] = time_ms(lambda: plain(full), 5, flush)
                row["bound_ms"], row["bound_by"] = bound_ms(ops, nbytes)
                row["prev_ms"] = CNN_PREV_MS[f"{model} {lp.name}"]
                row["prev_ms_source"] = CNN_PREV_MS_SOURCE
                n_ops = _lib.count_device_ops(lambda: kern(full))
                check(1 <= n_ops <= CNN_MAX_DEVICE_OPS[name],
                      f"{name} {model} {lp.name}: {n_ops} device operations "
                      f"per call (at most {CNN_MAX_DEVICE_OPS[name]})")
                row["device_ops_per_call"] = n_ops
                if name == "fused_qgemm":
                    # torch._int_mm: the int8 product alone (s8 operands,
                    # no rowsum or epilogue); it needs more than 16 rows
                    rows = max(m, 32)
                    a8 = torch.randint(0, 127, (rows, lp.k), generator=gen,
                                       dtype=torch.int8, device=dev)
                    w8 = w_lv.to(torch.int8)
                    row["library_call"] = f"torch._int_mm ({rows} rows)"
                    row["library_ms"] = time_ms(
                        lambda: torch._int_mm(a8, w8), 30, flush)
                else:
                    # F.conv2d on float32 levels, TF32 off: the product
                    # alone, in fp32 (the library has no u8 conv)
                    (pt, pb), (pl, pr) = pad_split(lp.in_h, lp.in_w, lp.kh,
                                                   lp.kw, lp.stride,
                                                   lp.padding)
                    xf = F.pad(x.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb))
                    wf = w_lv.float().reshape(lp.kh, lp.kw, lp.cin,
                                              lp.cout).permute(3, 2, 0, 1)
                    wf = wf.contiguous()
                    row["library_call"] = "F.conv2d fp32"
                    row["library_ms"] = time_ms(
                        lambda: F.conv2d(xf, wf, stride=lp.stride), 30, flush)
                    # a second yardstick: torch._int_mm on the same
                    # M x K x N GEMM view (s8 operands, no rowsum,
                    # epilogue or im2col)
                    a8 = torch.randint(0, 127, (m, lp.k), generator=gen,
                                       dtype=torch.int8, device=dev)
                    w8 = w_lv.to(torch.int8)
                    row["int_mm_ms"] = time_ms(
                        lambda: torch._int_mm(a8, w8), 30, flush)
            summary[name].append(row)
            print("KERNEL", json.dumps(row), flush=True)
    return summary


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def _int_mm_yardstick(a8: torch.Tensor, w8: torch.Tensor, flush) -> dict:
    """``torch._int_mm`` on the same int8 operands (rows padded with zeros
    to 32: cuBLASLt takes more than 16): the same int32 product, a
    yardstick the port never calls."""
    m = a8.shape[0]
    rows = max(m, 32)
    if rows > m:
        a8 = torch.cat([a8, a8.new_zeros((rows - m, a8.shape[1]))])
    return dict(library_call=f"torch._int_mm ({rows} rows)",
                library_ms=time_ms(lambda: torch._int_mm(a8, w8), 30, flush))


def bitplane_kernel_phase(flush: torch.Tensor) -> dict:
    """quantize_pack, bitgemm_packed and int8_matmul at the shapes the
    faithful and int8 engines give them on the main path (batch 8:
    svhn's six quantized layers, and AlexNet's six for the faithful
    kernels, fc5/fc6 for int8_matmul), each held against its plain
    version with ``torch.equal`` and timed beside its bound, its plain
    version and ``torch._int_mm`` on the levels."""
    from repro_torch.core.and_accum import _nibble_split, level_gemm_exact
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels.bitgemm import (bitgemm_packed,
                                             bitgemm_packed_plain)
    from repro_torch.kernels.bitgemm_mxu import int8_matmul, int8_matmul_plain
    from repro_torch.kernels.quantpack import (quantize_pack,
                                               quantize_pack_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    popc_rate = (torch.cuda.get_device_properties(0).multi_processor_count
                 * POPC_PER_SM_CLOCK * sm_clock_hz())
    summary = {"quantize_pack": [], "bitgemm_packed": [], "int8_matmul": []}

    def err(got, ref):
        return float((got.double() - ref.double()).abs().max())

    for model, lp in kernel_shapes():
        m, k, n = 8 * lp.out_h * lp.out_w, lp.k, lp.cout
        kwords = -(-k // 32)
        tag = dict(model=model, layer=lp.name, shape=[m, k, n])
        w_lv = torch.randint(0, 2, (k, n), generator=gen, dtype=torch.uint8,
                             device=dev)
        w_planes = ops.pack_weight_planes(w_lv, 1)
        for a_bits in ((1, 4) if model == "svhn" else (1,)):
            a_lv = torch.randint(0, 1 << a_bits, (m, k), generator=gen,
                                 dtype=torch.uint8, device=dev)
            a_planes = quantize_pack_plain(a_lv, a_bits)[1]
            kw = dict(a_bits=a_bits, w_bits=1)
            got = bitgemm_packed(a_planes, w_planes, **kw)
            ref = bitgemm_packed_plain(a_planes, w_planes, **kw)
            torch.cuda.synchronize()
            name = f"bitgemm_packed {model} {lp.name} a{a_bits}"
            check(torch.equal(got, ref), f"{name}: differs from the plain "
                                         f"version (max abs {err(got, ref)})")
            check(torch.equal(ref.double(), level_gemm_exact(a_lv, w_lv)),
                  f"{name}: the plain version is not the exact accumulator")
            row = dict(tag, a_bits=a_bits, w_bits=1, max_abs_err=err(got, ref),
                       ms=time_ms(lambda: bitgemm_packed(a_planes, w_planes,
                                                         **kw), 30, flush),
                       plain_ms=time_ms(lambda: bitgemm_packed_plain(
                           a_planes, w_planes, **kw), 5, flush),
                       popc_floor_ms=1e3 * m * n * kwords * a_bits / popc_rate,
                       **_int_mm_yardstick(a_lv.view(torch.int8),
                                           w_lv.view(torch.int8), flush))
            # Eq. 1's bit products: every plane pair over K
            row["bound_ms"], row["bound_by"] = bound_ms(
                0.0, 4 * (a_planes.numel() + w_planes.numel() + m * n),
                b1_ops=2.0 * m * n * k * a_bits)
            row.update(_bit_ops_and_prev(
                f"bitgemm_packed {model} {lp.name} a{a_bits}",
                lambda: bitgemm_packed(a_planes, w_planes, **kw)))
            summary["bitgemm_packed"].append(row)
            print("KERNEL", json.dumps(row), flush=True)

        # quantize_pack: float in (quant_dense_kernel) and levels in (the
        # faithful engine), timed at 4 bits beside a Tensor.copy_ of the
        # same input (a bytes yardstick: it reads and writes the input)
        a = torch.rand((m, k), generator=gen, device=dev) * 1.4 - 0.2
        qp_err = 0.0
        for bits in (1, 4):
            lv, pk = quantize_pack(a, bits)
            r_lv, r_pk = quantize_pack_plain(a, bits)
            lv2, pk2 = quantize_pack(r_lv, bits)
            torch.cuda.synchronize()
            check(torch.equal(lv, r_lv) and torch.equal(pk, r_pk)
                  and torch.equal(pk2, r_pk),
                  f"quantize_pack {model} {lp.name} b{bits}: levels or "
                  f"planes differ from the plain version")
            qp_err = max(qp_err, err(lv, r_lv), err(pk, r_pk), err(pk2, r_pk))
        plane_bytes = 4 * 4 * m * kwords
        # float in: clip, scale, round, clip — 6 float32 operations a value
        for form, x, nbytes, flops in (
                ("float in", a, 4 * m * k + m * k + plane_bytes, 6.0 * m * k),
                ("levels in", r_lv, m * k + plane_bytes, 0.0)):
            dst = torch.empty_like(x)
            row = dict(tag, form=form, bits=4, max_abs_err=qp_err,
                       ms=time_ms(lambda x=x: quantize_pack(x, 4), 30, flush),
                       plain_ms=time_ms(lambda x=x: quantize_pack_plain(x, 4),
                                        5, flush),
                       copy_ms=time_ms(lambda x=x, dst=dst: dst.copy_(x), 30,
                                       flush),
                       library_call="none: no single PyTorch call quantizes "
                                    "and packs bit planes",
                       library_ms=None)
            row["bound_ms"], row["bound_by"] = bound_ms(0.0, nbytes, flops)
            row.update(_bit_ops_and_prev(
                f"quantize_pack {model} {lp.name} {form}",
                lambda x=x: quantize_pack(x, 4), QP_PREV_MS,
                QP_PREV_MS_SOURCE))
            summary["quantize_pack"].append(row)
            print("KERNEL", json.dumps(row), flush=True)
        if model == "alexnet" and not lp.fc:
            continue   # the int8 path serves svhn; AlexNet's fc5/fc6 too

        # int8_matmul on the nibble groups of W1A8 levels
        a_lv = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.uint8,
                             device=dev)
        w8 = w_lv.view(torch.int8)
        groups = [g.view(torch.int8) for g, _ in _nibble_split(a_lv, 8)]
        for g in groups:
            got, ref = int8_matmul(g, w8), int8_matmul_plain(g, w8)
            torch.cuda.synchronize()
            check(torch.equal(got, ref),
                  f"int8_matmul {model} {lp.name}: nibble group differs from "
                  f"the plain version (max abs {err(got, ref)})")
        g = groups[0]
        row = dict(tag, operands="W1A8 nibble group (levels 0..15 x 0/1)",
                   launches_per_layer=len(groups), max_abs_err=err(got, ref),
                   ms=time_ms(lambda: int8_matmul(g, w8), 30, flush),
                   plain_ms=time_ms(lambda: int8_matmul_plain(g, w8), 5,
                                    flush),
                   **_int_mm_yardstick(g, w8, flush))
        row["bound_ms"], row["bound_by"] = bound_ms(2.0 * m * n * k,
                                                    m * k + k * n + 4 * m * n)
        row.update(_bit_ops_and_prev(f"int8_matmul {model} {lp.name}",
                                     lambda: int8_matmul(g, w8)))
        summary["int8_matmul"].append(row)
        print("KERNEL", json.dumps(row), flush=True)

    # one signed case: full-range s8 operands, negative values included
    a8 = torch.randint(-128, 128, (800, 256), generator=gen, dtype=torch.int8,
                       device=dev)
    b8 = torch.randint(-128, 128, (256, 512), generator=gen, dtype=torch.int8,
                       device=dev)
    a8[0], b8[:, 0] = -128, -128
    got, ref = int8_matmul(a8, b8), int8_matmul_plain(a8, b8)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"int8_matmul signed case differs from the "
                                 f"plain version (max abs {err(got, ref)})")
    summary["int8_matmul"].append(dict(
        case="signed s8 x s8, values -128..127", shape=[800, 256, 512],
        max_abs_err=err(got, ref)))

    # SmolLM's decode GEMMs: held and timed beside torch._int_mm at the
    # LM's padded rows, outside the main path (the LM keeps _int_mm)
    for k, n in LM_INT8_GEMMS:
        m = LM_INT8_ROWS
        a8 = torch.randint(-128, 128, (m, k), generator=gen, dtype=torch.int8,
                           device=dev)
        b8 = torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int8,
                           device=dev)
        got, ref = int8_matmul(a8, b8), int8_matmul_plain(a8, b8)
        torch.cuda.synchronize()
        name = f"int8_matmul smollm decode {k}x{n}"
        check(torch.equal(got, ref), f"{name}: differs from the plain "
                                     f"version (max abs {err(got, ref)})")
        pad = torch.cat([a8, a8.new_zeros((LM_INT_MM_ROWS - m, k))])
        row = dict(model="smollm-360m", case=f"decode GEMM K={k} N={n}",
                   main_path=False, shape=[m, k, n],
                   max_abs_err=err(got, ref),
                   ms=time_ms(lambda: int8_matmul(a8, b8), 30, flush),
                   plain_ms=time_ms(lambda: int8_matmul_plain(a8, b8), 5,
                                    flush),
                   library_call=f"torch._int_mm ({LM_INT_MM_ROWS} rows, as "
                                f"the LM pads them)",
                   library_ms=time_ms(lambda: torch._int_mm(pad, b8), 30,
                                      flush))
        row["bound_ms"], row["bound_by"] = bound_ms(2.0 * m * n * k,
                                                    m * k + k * n + 4 * m * n)
        n_ops = _lib.count_device_ops(lambda: int8_matmul(a8, b8))
        check(n_ops == 1, f"{name}: {n_ops} device operations per call")
        row["device_ops_per_call"] = n_ops
        summary["int8_matmul"].append(row)
        print("KERNEL", json.dumps(row), flush=True)
    return summary


def _bit_ops_and_prev(key: str, fn, prev: dict = BIT_PREV_MS,
                      source: str = BIT_PREV_MS_SOURCE) -> dict:
    """A bit-plane kernel row's device operations per call (failing above
    BIT_MAX_DEVICE_OPS) and its time before the redesign (a constant)."""
    from repro_torch.kernels import _lib

    name = key.split()[0]
    n_ops = _lib.count_device_ops(fn)
    check(1 <= n_ops <= BIT_MAX_DEVICE_OPS[name],
          f"{key}: {n_ops} device operations per call (at most "
          f"{BIT_MAX_DEVICE_OPS[name]})")
    return dict(device_ops_per_call=n_ops, prev_ms=prev[key],
                prev_ms_source=source)


def _kept_pairs(sq: int, causal: bool, window) -> int:
    """(query row, key) pairs one (batch, head) of contiguous attention
    keeps under its masks."""
    i = torch.arange(sq)[:, None]
    j = torch.arange(sq)[None, :]
    m = torch.ones((sq, sq), dtype=torch.bool)
    if causal:
        m &= j <= i
    if window:
        m &= j > i - window
    return int(m.sum())


def _paged_case(dev, gen, rs, *, b, s, hp, hkv, hd, ps, np_, p, idle=0,
                full=False):
    """Stale float32 pools, ragged page tables padded with the null page,
    ppos written for each slot's live positions and query rows at those
    positions.  ``idle`` trailing slots have no pages and q_pos -1 (idle
    decode slots); with s > 1 the last slot's final rows are padding;
    ``full`` fills every slot's whole table (p * ps tokens)."""
    pk = torch.randn((np_ + 1, ps, hkv, hd), generator=gen, device=dev)
    pv = torch.randn((np_ + 1, ps, hkv, hd), generator=gen, device=dev)
    pk[np_], pv[np_] = 0.0, 0.0
    ppos = np.full((np_ + 1, ps), -1, np.int32)
    table = np.full((b, p), np_, np.int32)
    q_pos = np.full((b, s), -1, np.int32)
    pages = list(rs.permutation(np_))
    for i in range(b - idle):
        n_tok = p * ps if full else int(rs.randint(s, p * ps + 1))
        own = np.array([pages.pop() for _ in range(-(-n_tok // ps))])
        table[i, :len(own)] = own
        t = np.arange(n_tok)
        ppos[own[t // ps], t % ps] = t
        q_pos[i] = np.arange(n_tok - s, n_tok)
    if s > 1:
        q_pos[b - idle - 1, s - s // 3:] = -1
    q = torch.randn((b, s, hp, hd), generator=gen, device=dev)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return q, pk, pv, to(ppos), to(table), to(q_pos)


def lm_kernel_phase(flush: torch.Tensor) -> dict:
    """attn_flash and attn_paged at the LM main path's shapes, held
    against their plain versions (float32 and bfloat16 inputs) and timed
    in bfloat16 beside their bound and F.scaled_dot_product_attention
    (bf16, unquantized q/k/v; for paged, on K/V already gathered through
    the table and expanded for GQA)."""
    import torch.nn.functional as F

    from repro_torch.kernels import _lib
    from repro_torch.kernels.attn_flash import attn_flash, attn_paged

    def bf16_elementwise(tag, got, ref32, vmax) -> float:
        """Worst |got - ref| / (ATTN_TOL_BF16 |ref| + ATTN_TOL_F32 max|v|)
        of a bf16 output against the plain version's float32 result on the
        same (upcast) inputs: one output rounding is at most 2^-8 |ref|."""
        d = (got.float() - ref32).abs()
        worst = float((d / (ATTN_TOL_BF16 * ref32.abs()
                            + ATTN_TOL_F32 * vmax)).max())
        check(worst <= 1.0, f"{tag} bf16: an element is off its float32 "
                            f"plain result by {worst} x its tolerance")
        return worst

    def device_ops(name, case, fn) -> int:
        n = _lib.count_device_ops(fn)
        check(1 <= n <= ATTN_MAX_DEVICE_OPS[name],
              f"{name} {case}: {n} device operations per call (at most "
              f"{ATTN_MAX_DEVICE_OPS[name]})")
        return n

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rs = np.random.RandomState(5)
    summary = {"attn_flash": [], "attn_paged": []}
    for case, (b, sq, h, hd, window) in (
            ("bucket prefill", (LM_BATCH, LM_PROMPT, 15, 64, None)),
            ("window 256", (1, LM_PROMPT, 15, 64, 256))):
        q, k, v = (torch.randn((b, sq, h, hd), generator=gen, device=dev)
                   for _ in range(3))
        kw = dict(causal=True, window=window)
        got, ref = attn_flash(q, k, v, **kw), attn_flash(q, k, v,
                                                         reference=True, **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = ATTN_TOL_F32 * float(v.abs().max())
        check(err <= tol, f"attn_flash {case} f32: max abs {err} > {tol}")
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        got_b = attn_flash(qb, kb, vb, **kw)
        ref_b = attn_flash(qb, kb, vb, reference=True, **kw)
        err_b = float((got_b.float() - ref_b.float()).abs().max())
        tol_b = ATTN_TOL_BF16 * float(vb.float().abs().max())
        check(err_b <= tol_b, f"attn_flash {case} bf16: max abs {err_b} > "
                              f"{tol_b}")
        elem_b = bf16_elementwise(
            f"attn_flash {case}", got_b, attn_flash(
                qb.float(), kb.float(), vb.float(), reference=True, **kw),
            float(vb.float().abs().max()))
        pairs = b * h * _kept_pairs(sq, True, window)
        nbytes = 4 * b * sq * h * hd * 2      # q, k, v in, out, bf16
        t = [x.transpose(1, 2).contiguous() for x in (qb, kb, vb)]
        if window:
            i = torch.arange(sq, device=dev)
            mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
            lib = lambda t=t, mask=mask: F.scaled_dot_product_attention(  # noqa: E731
                *t, attn_mask=mask)
        else:
            lib = lambda t=t: F.scaled_dot_product_attention(  # noqa: E731
                *t, is_causal=True)
        row = dict(case=case, shape=[b, sq, h, hd], window=window,
                   max_abs_err=err, tol=tol, max_abs_err_bf16=err_b,
                   tol_bf16=tol_b, bf16_elementwise_worst=elem_b,
                   ms=time_ms(lambda: attn_flash(qb, kb, vb, **kw), 20, flush),
                   plain_ms=time_ms(lambda: attn_flash(
                       qb, kb, vb, reference=True, **kw), 3, flush),
                   library_call="F.scaled_dot_product_attention bf16",
                   library_ms=time_ms(lib, 20, flush),
                   prev_ms=ATTN_PREV_MS[case],
                   prev_ms_source=PREV_MS_SOURCE,
                   device_ops_per_call=device_ops(
                       "attn_flash", case,
                       lambda: attn_flash(qb, kb, vb, **kw)))
        row["bound_ms"], row["bound_by"] = bound_ms(
            2.0 * hd * pairs, nbytes, bf16_flops=2.0 * hd * pairs)
        summary["attn_flash"].append(row)
        print("KERNEL attn_flash", json.dumps(row), flush=True)

    p_tab = -(-(CONT_PROMPTS[1] + CONT_HORIZONS[1]) // CONT_PAGE)
    for case, (b, s, idle, p, np_, full) in (
            ("decode step", (CONT_SLOTS, 1, 1, p_tab, CONT_PAGES, False)),
            ("prefill chunk", (1, CONT_PAGE, 0, p_tab, CONT_PAGES, False)),
            ("decode step, 128-page tables",
             (CONT_SLOTS, 1, 0, 128, CONT_SLOTS * 128 + 16, True))):
        hp, hkv, hd = 15, 5, 64
        q, pk, pv, ppos, table, q_pos = _paged_case(
            dev, gen, rs, b=b, s=s, hp=hp, hkv=hkv, hd=hd, ps=CONT_PAGE,
            np_=np_, p=p, idle=idle, full=full)
        kw = dict(causal=True, quantized=True, n_q_heads=hp)
        valid = q_pos >= 0
        errs = {}
        for dtype, rel in ((torch.float32, ATTN_TOL_F32),
                           (torch.bfloat16, ATTN_TOL_BF16)):
            args = (q.to(dtype), pk.to(dtype), pv.to(dtype), ppos, table,
                    q_pos)
            got = attn_paged(*args, **kw).float()
            ref = attn_paged(*args, reference=True, **kw).float()
            torch.cuda.synchronize()
            tol = rel * float(args[2].float().abs().max())
            e_valid = float((got[valid] - ref[valid]).abs().max())
            e_pad = (float((got[~valid] - ref[~valid]).abs().max())
                     if bool((~valid).any()) else 0.0)
            check(e_valid <= tol and e_pad <= tol,
                  f"attn_paged {case} {dtype}: max abs {e_valid} (valid "
                  f"rows), {e_pad} (padding rows) > {tol}")
            errs[str(dtype).split(".")[1]] = (e_valid, e_pad, tol)
        bq, bk, bv = (x.bfloat16() for x in (q, pk, pv))
        elem_b = bf16_elementwise(
            f"attn_paged {case}",
            attn_paged(bq, bk, bv, ppos, table, q_pos, **kw),
            attn_paged(bq.float(), bk.float(), bv.float(), ppos, table, q_pos,
                       reference=True, **kw),
            float(bv.float().abs().max()))
        args = (q.bfloat16(), pk.bfloat16(), pv.bfloat16(), ppos, table,
                q_pos)
        tl = table.long()
        live = tl != np_
        pos_g = ppos[tl].reshape(b, -1)                    # (B, P*ps)
        keep = ((pos_g[:, None, :] >= 0)
                & (pos_g[:, None, :] <= q_pos[:, :, None]) & valid[..., None])
        pairs = hp * int(keep.sum())
        n_live = int(live.sum())
        nbytes = (2 * q.numel() * 2                        # q in, out (bf16)
                  + n_live * CONT_PAGE * hkv * hd * 2 * 2  # live K, V pages
                  + n_live * CONT_PAGE * 4                 # their positions
                  + table.numel() * 4 + q_pos.numel() * 4)
        idx = torch.clamp(torch.arange(hp, device=dev) // (hp // hkv),
                          max=hkv - 1)
        kg = args[1][tl].reshape(b, -1, hkv, hd)[:, :, idx].transpose(1, 2)
        vg = args[2][tl].reshape(b, -1, hkv, hd)[:, :, idx].transpose(1, 2)
        qt = args[0].transpose(1, 2)
        mask = keep[:, None]
        row = dict(case=case, main_path=not full, slots=b, rows=s,
                   heads=[hp, hkv], head_dim=hd,
                   page_size=CONT_PAGE, table_pages=p, live_pages=n_live,
                   kept_pairs=pairs, max_abs_err=errs["float32"][0],
                   max_abs_err_padding_rows=errs["float32"][1],
                   tol=errs["float32"][2], max_abs_err_bf16=errs["bfloat16"][0],
                   tol_bf16=errs["bfloat16"][2],
                   bf16_elementwise_worst=elem_b,
                   ms=time_ms(lambda: attn_paged(*args, **kw), 30, flush),
                   plain_ms=time_ms(lambda: attn_paged(
                       *args, reference=True, **kw), 5, flush),
                   library_call="F.scaled_dot_product_attention bf16 on "
                                "gathered, GQA-expanded K/V",
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       qt, kg, vg, attn_mask=mask), 30, flush),
                   prev_ms=ATTN_PREV_MS.get(case),
                   prev_ms_source=PREV_MS_SOURCE,
                   device_ops_per_call=device_ops(
                       "attn_paged", case, lambda: attn_paged(*args, **kw)))
        row["bound_ms"], row["bound_by"] = bound_ms(
            2.0 * hd * pairs, nbytes, bf16_flops=2.0 * hd * pairs)
        summary["attn_paged"].append(row)
        print("KERNEL attn_paged", json.dumps(row), flush=True)
    return summary


def _max_diff(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _check_logits(tag: str, got: np.ndarray, ref: np.ndarray,
                  exact: bool = False) -> dict:
    tol = 0.0 if exact else LOGIT_TOL_FRAC * float(np.abs(ref).max())
    check(np.all(np.isfinite(ref)), f"{tag}: non-finite reference")
    d = _max_diff(got, ref)
    check(np.all(np.isfinite(got)), f"{tag}: non-finite logits")
    check((np.argmax(got, -1) == np.argmax(ref, -1)).all(),
          f"{tag}: argmax differs")
    check(d <= tol, f"{tag}: max |dlogit| {d} > {tol}")
    return dict(max_abs=d, tol=tol, bit_identical=bool(d == 0.0))


def serve_window(engine, images) -> tuple[dict, list]:
    """Serve for WINDOW_S seconds through ``engine``, a closed loop that
    submits CONCURRENCY requests (the images in turn), drains them, and
    submits the next CONCURRENCY.  Requests/s is every request over the
    whole window's wall time; latencies run from submit to harvest."""
    d0 = engine.stats["dispatches"]
    lat, vals = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WINDOW_S:
        res = engine.serve([images[i % len(images)]
                            for i in range(CONCURRENCY)])
        lat += [r.latency_s for r in res]
        vals += [r.value for r in res]
    wall = time.perf_counter() - t0
    lat.sort()
    return dict(
        window_s=wall, requests=len(lat), concurrency=CONCURRENCY,
        dispatches=engine.stats["dispatches"] - d0,
        requests_per_s=len(lat) / wall,
        p50_latency_ms=1e3 * lat[len(lat) // 2],
        p99_latency_ms=1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
    ), vals


def main_path(card: str) -> dict:
    from repro_torch import api
    from repro_torch.core.quant import W1A4, W1A8
    from repro_torch.kernels import _lib
    from repro_torch.models.cnn import alexnet_spec, init_cnn, svhn_cnn_spec

    dev = torch.device("cuda")
    rs = np.random.RandomState(1)
    images = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
              for _ in range(16)]
    svhn_params = init_cnn(torch.Generator(device=dev).manual_seed(0),
                           svhn_cnn_spec())
    deps = {}
    for q in (W1A4, W1A8):
        compiled = api.build(svhn_cnn_spec(), q, params=svhn_params,
                             img_hw=40).compile(target="cuda",
                                                batch_hints=(1, 8))
        deps[q.tag()] = (compiled, compiled.serve(max_batch=8))
        deps[q.tag()][1].predict(images[:8])      # warm-up, not counted
    alex_params = init_cnn(torch.Generator(device=dev).manual_seed(1),
                           alexnet_spec())
    alex = api.build(alexnet_spec(), W1A8, params=alex_params,
                     img_hw=224).compile(target="cuda", batch_hints=(8,))
    x_alex = torch.from_numpy(
        rs.uniform(0, 1, (8, 224, 224, 3)).astype(np.float32)).to(dev)
    alex.forward(x_alex)                          # warm-up, not counted
    torch.cuda.synchronize()

    # ---- the main path, counted
    rounds = {tag: [] for tag in deps}
    windows = {}
    d0 = {tag: dep.stats["dispatches"] for tag, (_, dep) in deps.items()}
    _lib.reset_launches()
    for tag, (compiled, dep) in deps.items():
        for _ in range(SERVE_ROUNDS):
            rounds[tag].append(dep.engine.serve(images))
        windows[tag] = serve_window(dep.engine, images)
    t0 = time.perf_counter()
    alex_logits = alex.forward(x_alex)
    torch.cuda.synchronize()
    alex_s = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    # ----

    svhn_dispatches = sum(dep.stats["dispatches"] - d0[tag]
                          for tag, (_, dep) in deps.items())
    want = {k: 0 for k in launches}
    want.update(conv_implicit=5 * svhn_dispatches + 4,
                fused_qgemm=1 * svhn_dispatches + 2)
    check(launches == want, f"launch counts {launches} != expected {want}")
    report = {"launches": launches, "svhn": {}, "alexnet": {}}
    for tag, rr in rounds.items():
        compiled, dep = deps[tag]
        vals = [np.stack([r.value for r in res]) for res in rr]
        got = vals[-1]
        check(got.shape == (16, 10), f"svhn {tag}: logits {got.shape}")
        check(all(np.array_equal(v, got) for v in vals),
              f"svhn {tag}: rounds of the same requests differ")
        ref = np.concatenate([
            compiled.forward(torch.from_numpy(np.stack(images[i:i + 8])).to(dev),
                             reference=True).cpu().numpy()
            for i in (0, 8)])
        vs_plain = _check_logits(f"svhn {tag} vs plain", got, ref, exact=True)
        alone = np.stack([dep.predict([img])[0] for img in images])
        vs_alone = _check_logits(f"svhn {tag} alone vs batched", alone, got)
        win, win_vals = windows[tag]
        # the window's buckets hold the same 8 images as the set's buckets
        check(all(np.array_equal(v, got[i % 16]) for i, v in
                  enumerate(win_vals)),
              f"svhn {tag}: window results differ from the request set's")
        report["svhn"][tag] = dict(
            correctness_set=dict(requests=16, rounds=len(rr), dispatches=2),
            serving_window=win, vs_plain=vs_plain, alone_vs_batched=vs_alone,
            card=card)
    got = alex_logits.cpu().numpy()
    check(got.shape == (8, 1000), f"alexnet: logits {got.shape}")
    ref = alex.forward(x_alex, reference=True).cpu().numpy()
    alone = np.concatenate([alex.forward(x_alex[i:i + 1]).cpu().numpy()
                            for i in range(8)])
    # with per-sample norm statistics a 1x1 map normalizes to beta, so the
    # logits past fc5 do not depend on the image; fc5's own output (after
    # every conv kernel and the first fc kernel) does, and is held too
    from repro_torch.core import plan as P

    head = P.layers_for_batch(alex.plan, 8)[:6]
    feats = P.execute_cnn_layers(head, alex.params[:6], x_alex, W1A8)
    feats_ref = P.execute_cnn_layers(head, alex.params[:6], x_alex, W1A8,
                                     reference=True)
    fwd_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        alex.forward(x_alex)
        torch.cuda.synchronize()
        fwd_ms.append(1e3 * (time.perf_counter() - t1))
    report["alexnet"] = dict(
        batch=8, forward_ms_counted_run=1e3 * alex_s,
        forward_ms_median_of_5=sorted(fwd_ms)[2],
        vs_plain=_check_logits("alexnet vs plain", got, ref, exact=True),
        alone_vs_batched=_check_logits("alexnet alone vs batched", alone,
                                       got),
        fc5_vs_plain=_check_logits("alexnet fc5 vs plain",
                                   feats.cpu().numpy(),
                                   feats_ref.cpu().numpy(), exact=True),
        card=card)
    svhn8 = torch.from_numpy(np.stack(images[:8])).to(dev)
    report["profile"] = {
        "svhn_w1a8_b8": profile_forward(
            lambda: deps["w1a8g8"][0].forward(svhn8), 20),
        "alexnet_w1a8_b8": profile_forward(lambda: alex.forward(x_alex), 5),
        "card": card}
    print("MAIN", json.dumps(report), flush=True)
    return report


def bitplane_main_path(card: str) -> dict:
    """The faithful and int8 engines through the serving entry points:
    svhn at W1A1 and W1A4 on ``faithful`` and at W1A8 on ``int8`` (the
    same weights and requests as :func:`main_path`), AlexNet W1A1 on
    ``faithful``; every logit held exactly to the plain versions and to
    the default engines."""
    import dataclasses

    from repro_torch import api
    from repro_torch.core import plan as P
    from repro_torch.core.quant import PAPER_CONFIGS, W1A1
    from repro_torch.kernels import _lib
    from repro_torch.models.cnn import alexnet_spec, init_cnn, svhn_cnn_spec

    dev = torch.device("cuda")
    rs = np.random.RandomState(1)
    images = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
              for _ in range(16)]
    x_alex = torch.from_numpy(
        rs.uniform(0, 1, (8, 224, 224, 3)).astype(np.float32)).to(dev)
    batches = [torch.from_numpy(np.stack(images[i:i + 8])).to(dev)
               for i in (0, 8)]
    spec = svhn_cnn_spec()
    svhn_params = init_cnn(torch.Generator(device=dev).manual_seed(0), spec)

    def compile_svhn(q):
        return api.build(spec, q, params=svhn_params, img_hw=40).compile(
            target="cuda", batch_hints=(1, 8))

    deps, defaults = {}, {}
    for qname, engine in BITPLANE_PATHS:
        q = PAPER_CONFIGS[qname]
        compiled = compile_svhn(dataclasses.replace(q, engine=engine))
        check({lp.engine for lp in compiled.plan.layers if not lp.fp}
              == {engine}, f"svhn {qname} {engine}: plan engines "
                           f"{[lp.engine for lp in compiled.plan.layers]}")
        tag = f"{qname} {engine}"
        deps[tag] = (qname, compiled, compiled.serve(max_batch=8))
        deps[tag][2].predict(images[:8])          # warm-up, not counted
        defaults[qname] = compile_svhn(q)
    alex_params = init_cnn(torch.Generator(device=dev).manual_seed(1),
                           alexnet_spec())
    alex, alex_default = (api.build(alexnet_spec(), q, params=alex_params,
                                    img_hw=224).compile(target="cuda",
                                                        batch_hints=(8,))
                          for q in (dataclasses.replace(W1A1,
                                                        engine="faithful"),
                                    W1A1))
    alex.forward(x_alex)                          # warm-up, not counted
    torch.cuda.synchronize()

    # ---- the faithful and int8 main path, counted
    rounds = {tag: [] for tag in deps}
    windows = {}
    d0 = {tag: dep.stats["dispatches"] for tag, (_, _, dep) in deps.items()}
    _lib.reset_launches()
    for tag, (_, _, dep) in deps.items():
        for _ in range(SERVE_ROUNDS):
            rounds[tag].append(dep.engine.serve(images))
        if tag in BITPLANE_WINDOWS:
            windows[tag] = serve_window(dep.engine, images)
    t0 = time.perf_counter()
    alex_logits = alex.forward(x_alex)
    torch.cuda.synchronize()
    alex_s = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    # ----

    disp = {tag: dep.stats["dispatches"] - d0[tag]
            for tag, (_, _, dep) in deps.items()}
    faithful = sum(d for tag, d in disp.items() if tag.endswith("faithful"))
    want = {k: 0 for k in launches}
    want.update(quantize_pack=6 * faithful + 6,
                bitgemm_packed=6 * faithful + 6,
                int8_matmul=12 * disp["w1a8 int8"])
    check(launches == want, f"faithful/int8 launch counts {launches} != "
                            f"expected {want}")
    report = {"launches": launches, "dispatches": disp, "svhn": {},
              "alexnet": {}}
    for tag, rr in rounds.items():
        qname, compiled, dep = deps[tag]
        vals = [np.stack([r.value for r in res]) for res in rr]
        got = vals[-1]
        check(got.shape == (16, 10), f"svhn {tag}: logits {got.shape}")
        check(all(np.array_equal(v, got) for v in vals),
              f"svhn {tag}: rounds of the same requests differ")
        ref = np.concatenate([compiled.forward(b, reference=True).cpu().numpy()
                              for b in batches])
        default = np.concatenate([defaults[qname].forward(b).cpu().numpy()
                                  for b in batches])
        alone = np.stack([dep.predict([img])[0] for img in images])
        report["svhn"][tag] = dict(
            correctness_set=dict(requests=16, rounds=len(rr), dispatches=2),
            vs_plain=_check_logits(f"svhn {tag} vs plain", got, ref,
                                   exact=True),
            vs_default_engines=_check_logits(f"svhn {tag} vs default engines",
                                             got, default, exact=True),
            alone_vs_batched=_check_logits(f"svhn {tag} alone vs batched",
                                           alone, got),
            card=card)
        if tag in windows:
            win, win_vals = windows[tag]
            check(all(np.array_equal(v, got[i % 16]) for i, v in
                      enumerate(win_vals)),
                  f"svhn {tag}: window results differ from the request set's")
            report["svhn"][tag]["serving_window"] = win

    # the default engines' W1A1 window beside faithful W1A1's (the default
    # W1A8 window is main_path's); outside the counted run
    dep = defaults["w1a1"].serve(max_batch=8)
    dep.predict(images[:8])
    report["svhn"]["w1a1 default"] = dict(
        serving_window=serve_window(dep.engine, images)[0], card=card)

    got = alex_logits.cpu().numpy()
    check(got.shape == (8, 1000), f"alexnet faithful: logits {got.shape}")
    head = P.layers_for_batch(alex.plan, 8)[:6]
    head_d = P.layers_for_batch(alex_default.plan, 8)[:6]
    check({lp.engine for lp in head if not lp.fp} == {"faithful"},
          "alexnet faithful: head engines")
    feats = P.execute_cnn_layers(head, alex.params[:6], x_alex, alex.plan.quant)
    feats_ref = P.execute_cnn_layers(head, alex.params[:6], x_alex,
                                     alex.plan.quant, reference=True)
    feats_d = P.execute_cnn_layers(head_d, alex_default.params[:6], x_alex,
                                   W1A1)
    report["alexnet"] = dict(
        quant="w1a1 faithful", batch=8, forward_ms_counted_run=1e3 * alex_s,
        vs_plain=_check_logits("alexnet faithful vs plain", got,
                               alex.forward(x_alex, reference=True)
                               .cpu().numpy(), exact=True),
        vs_default_engines=_check_logits(
            "alexnet faithful vs default engines", got,
            alex_default.forward(x_alex).cpu().numpy(), exact=True),
        fc5_vs_plain=_check_logits("alexnet faithful fc5 vs plain",
                                   feats.cpu().numpy(),
                                   feats_ref.cpu().numpy(), exact=True),
        fc5_vs_default_engines=_check_logits(
            "alexnet faithful fc5 vs default engines", feats.cpu().numpy(),
            feats_d.cpu().numpy(), exact=True),
        card=card)
    report["profile"] = {
        tag: profile_forward(lambda c=deps[tag][1]: c.forward(batches[0]), 20)
        for tag in deps}
    report["profile"]["alexnet w1a1 faithful"] = profile_forward(
        lambda: alex.forward(x_alex), 5)
    report["profile"]["card"] = card
    report["quant_dense_kernel"] = dense_kernel_check()
    print("BITPLANE MAIN", json.dumps(report), flush=True)
    return report


def dense_kernel_check() -> dict:
    """``quant_dense_kernel`` (float in) at AlexNet fc5's shape, (8, 9216)
    x (9216, 4096), W1A1 and W1A4: the mxu and faithful paths equal each
    other and their plain-version runs exactly, with one quantize_pack and
    one bitgemm_packed or int8_matmul launch per call."""
    from repro_torch.kernels import _lib, ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    a = torch.rand((8, 9216), generator=gen, device=dev) * 1.4 - 0.2
    w = torch.randn((9216, 4096), generator=gen, device=dev)
    out = {}
    for a_bits in (1, 4):
        res, counts = {}, {}
        for path, kern in (("mxu", "int8_matmul"),
                           ("faithful", "bitgemm_packed")):
            _lib.reset_launches()
            res[path] = ops.quant_dense_kernel(a, w, a_bits, 1, path=path)
            torch.cuda.synchronize()
            counts[path] = dict(_lib.LAUNCHES)
            want = {k: 0 for k in counts[path]}
            want.update({"quantize_pack": 1, kern: 1})
            check(counts[path] == want, f"quant_dense_kernel {path} "
                                        f"a{a_bits}: launches {counts[path]}")
            plain = ops.quant_dense_kernel(a, w, a_bits, 1, path=path,
                                           reference=True)
            check(torch.equal(res[path], plain),
                  f"quant_dense_kernel {path} a{a_bits}: differs from the "
                  f"plain versions")
        check(torch.equal(res["mxu"], res["faithful"]),
              f"quant_dense_kernel a{a_bits}: mxu and faithful differ")
        check(res["mxu"].shape == (8, 4096)
              and bool(torch.isfinite(res["mxu"]).all()),
              f"quant_dense_kernel a{a_bits}: shape or values")
        out[f"w1a{a_bits}"] = dict(shape=[8, 9216, 4096], paths_equal=True,
                                   vs_plain="equal", launches={
                                       p: {k: v for k, v in c.items() if v}
                                       for p, c in counts.items()})
    return out


def _hold_tokens(tag: str, got: np.ndarray, ref: np.ndarray,
                 margins: np.ndarray) -> dict:
    """Greedy tokens of one request (or rows of a batch) against the
    oracle's: equal, or first different at a position whose oracle top-2
    logit margin is under LM_MARGIN_TOL.  Later positions follow another
    prefix and are not compared."""
    got, ref = np.atleast_2d(got), np.atleast_2d(ref)
    margins = np.atleast_2d(margins)
    check(got.shape == ref.shape, f"{tag}: tokens {got.shape} vs {ref.shape}")
    div = []
    for r in range(got.shape[0]):
        diff = np.flatnonzero(got[r] != ref[r])
        if diff.size == 0:
            continue
        t = int(diff[0])
        m = float(margins[r, t])
        check(m < LM_MARGIN_TOL, f"{tag}: row {r} differs at position {t} "
                                 f"where the oracle's top-2 margin is {m} "
                                 f">= {LM_MARGIN_TOL}")
        div.append(dict(row=r, position=t, margin=m))
    return dict(positions=int(got.size), divergences=div)


def lm_main_path(card: str) -> dict:
    """Full-width SmolLM-360M W1A8 through both LM entry points."""
    import dataclasses

    from repro_torch.configs import SINGLE, get_config
    from repro_torch.core.quant import W1A8
    from repro_torch.kernels import _lib
    from repro_torch.launch.engine import (ContinuousLMEngine, LMRunner,
                                           ServeEngine)
    from repro_torch.launch.serve import serve_once
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import prequantize_params

    dev = torch.device("cuda")
    phases = {}
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("smollm-360m"), quant=W1A8)
    params = prequantize_params(T.init_lm(
        torch.Generator(device=dev).manual_seed(2), cfg, SINGLE), cfg)
    torch.cuda.synchronize()
    phases["init_and_prequantize_s"] = time.perf_counter() - t0
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, cfg.vocab, LM_PROMPT).astype(np.int32)
               for _ in range(LM_BATCH)]
    payloads = [(rs.randint(0, cfg.vocab, rs.randint(
        CONT_PROMPTS[0], CONT_PROMPTS[1] + 1)).astype(np.int32),
        int(rs.randint(CONT_HORIZONS[0], CONT_HORIZONS[1] + 1)))
        for _ in range(CONT_REQUESTS)]
    max_seq = CONT_PROMPTS[1] + CONT_HORIZONS[1]

    def cont_engine(**kw):
        return ContinuousLMEngine(params, cfg, num_slots=CONT_SLOTS,
                                  page_size=CONT_PAGE, num_pages=CONT_PAGES,
                                  max_seq=max_seq, new_tokens=LM_NEW, **kw)

    bucket = ServeEngine(LMRunner(params, cfg, new_tokens=LM_NEW),
                         max_batch=LM_BATCH)
    cont = cont_engine()
    t0 = time.perf_counter()
    bucket.serve([prompts[0][:64]])                 # warm-up, not counted
    cont.serve([(payloads[0][0][:CONT_PAGE], 2)])   # warm-up, not counted
    torch.cuda.synchronize()
    phases["warm_up_s"] = time.perf_counter() - t0

    # ---- the LM main path, counted
    b0, c0 = bucket.stats["dispatches"], cont.stats["dispatches"]
    steps0 = cont.stats["steps"]
    _lib.reset_launches()
    t0 = time.perf_counter()
    b_res = bucket.serve(prompts)
    t_bucket = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_res = cont.serve(payloads)
    t_cont = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    # ----
    phases["bucket_s"], phases["continuous_s"] = t_bucket, t_cont
    b_disp = bucket.stats["dispatches"] - b0
    c_disp = cont.stats["dispatches"] - c0
    want = {k: 0 for k in launches}
    want.update(attn_flash=cfg.n_layers * b_disp,
                attn_paged=cfg.n_layers * c_disp)
    check(launches == want, f"LM launch counts {launches} != expected {want}")
    check(b_disp == 1, f"bucket engine: {b_disp} dispatches for one bucket")

    # tokens against the plain versions, and continuous against alone
    t0 = time.perf_counter()
    b_tok = np.stack([r.value for r in b_res])
    check(b_tok.shape == (LM_BATCH, LM_NEW), f"bucket tokens {b_tok.shape}")
    margins = []
    ref_tok, _ = serve_once(params, cfg, SINGLE,
                            torch.from_numpy(np.stack(prompts)).to(dev),
                            LM_NEW, "serve", reference=True, margins=margins)
    bucket_vs_plain = _hold_tokens(
        "bucket vs plain", b_tok, ref_tok.cpu().numpy(),
        torch.stack(margins, dim=1).cpu().numpy())
    ref_eng = cont_engine(reference=True, record_margins=True)
    c_ref = ref_eng.serve(payloads)
    del ref_eng
    alone_eng = cont_engine(record_margins=True)
    c_alone = [alone_eng.serve([p])[0] for p in payloads]
    del alone_eng
    cont_vs_plain = dict(positions=0, divergences=[])
    cont_vs_alone = dict(positions=0, divergences=[])
    for i, (r, ref, alone) in enumerate(zip(c_res, c_ref, c_alone)):
        check(len(r.value) == payloads[i][1],
              f"continuous request {i}: {len(r.value)} tokens")
        check(np.all((r.value >= 0) & (r.value < cfg.vocab)),
              f"continuous request {i}: token outside the vocab")
        for acc, oracle, tag in ((cont_vs_plain, ref, "plain"),
                                 (cont_vs_alone, alone, "alone")):
            h = _hold_tokens(f"continuous request {i} vs {tag}", r.value,
                             oracle.value, oracle.margins)
            acc["positions"] += h["positions"]
            acc["divergences"] += [dict(d, request=i)
                                   for d in h["divergences"]]
    # the logits behind the first token, kernels vs plain versions
    layers = T.unstack_layers(params, cfg)
    toks = torch.from_numpy(np.stack(prompts)).to(dev)
    lk, _ = T.prefill(params, cfg, SINGLE, tokens=toks, layers=layers)
    lp, _ = T.prefill(params, cfg, SINGLE, tokens=toks, layers=layers,
                      reference=True)
    last_k, last_p = lk[:, -1, :cfg.vocab], lp[:, -1, :cfg.vocab]
    check(bool(torch.isfinite(last_k).all()), "prefill logits not finite")
    prefill_logits = dict(
        max_abs_diff=float((last_k - last_p).abs().max()),
        max_abs_logit=float(last_p.abs().max()),
        argmax_equal=bool(torch.equal(last_k.argmax(-1), last_p.argmax(-1))))
    del lk, lp
    phases["oracle_runs_s"] = time.perf_counter() - t0

    emitted = sum(len(r.value) for r in c_res)
    lat = sorted(r.latency_s for r in c_res)
    report = dict(
        launches=launches, card=card,
        bucket=dict(requests=LM_BATCH, prompt_len=LM_PROMPT,
                    new_tokens=LM_NEW, dispatches=b_disp, wall_s=t_bucket,
                    requests_per_s=LM_BATCH / t_bucket,
                    tokens_per_s=LM_BATCH * LM_NEW / t_bucket,
                    prompt_tokens_per_s=LM_BATCH * LM_PROMPT / t_bucket,
                    vs_plain=bucket_vs_plain),
        continuous=dict(requests=CONT_REQUESTS, slots=CONT_SLOTS,
                        page_size=CONT_PAGE, pages=CONT_PAGES,
                        prompt_tokens=sum(len(p[0]) for p in payloads),
                        emitted_tokens=emitted, dispatches=c_disp,
                        steps=cont.stats["steps"] - steps0,
                        wall_s=t_cont, requests_per_s=CONT_REQUESTS / t_cont,
                        tokens_per_s=emitted / t_cont,
                        p50_latency_ms=1e3 * lat[len(lat) // 2],
                        p99_latency_ms=1e3 * lat[-1],
                        pool=cont.pool.stats(), vs_plain=cont_vs_plain,
                        vs_alone=cont_vs_alone),
        prefill_last_logits_vs_plain=prefill_logits)
    del cont
    t0 = time.perf_counter()
    report["profile"] = lm_profiles(params, cfg, layers, cont_engine)
    phases["profile_s"] = time.perf_counter() - t0
    report["phases_s"] = phases
    print("LM", json.dumps(report), flush=True)
    print("LM DIVERGENT POSITIONS", json.dumps(dict(
        bucket_vs_plain=len(bucket_vs_plain["divergences"]),
        continuous_vs_plain=len(cont_vs_plain["divergences"]),
        continuous_vs_alone=len(cont_vs_alone["divergences"]))), flush=True)
    # the plan-free bucket run, for the plan phase to hold its tokens to
    report["bucket_run"] = dict(prompts=prompts, tokens=b_tok,
                                margins=torch.stack(margins,
                                                    dim=1).cpu().numpy())
    return report


def _sync_ms(fn):
    """(result, wall ms) of ``fn()``, the card synchronized on both
    sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def resilience_phase(card: str) -> dict:
    """Plan artifacts, resilient CNN serving with a degrade, a resumed LM
    decode and a resumed continuous engine, on the card."""
    import dataclasses
    import shutil

    from repro_torch import api
    from repro_torch.configs import SINGLE, get_config
    from repro_torch.core.quant import W1A1, W1A8
    from repro_torch.kernels import _lib
    from repro_torch.launch.engine import (CNNRunner, ContinuousLMEngine,
                                           ServeEngine)
    from repro_torch.models import transformer as T
    from repro_torch.models.cnn import init_cnn, svhn_cnn_spec
    from repro_torch.models.layers import prequantize_params
    from repro_torch.pim.intermittent import plan_resume_study
    from repro_torch.resilience import (DegradePolicy, EpochLMRunner,
                                        FaultPlan, ResilienceConfig,
                                        ResilientServeEngine)

    dev = torch.device("cuda")
    work = os.path.join(ROOT, "build", "resilience")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    report = dict(card=card)

    # ---- plan artifacts: compile, save, reload, a fresh-process reload
    spec = svhn_cnn_spec()
    params = init_cnn(torch.Generator(device=dev).manual_seed(0), spec)
    primary, compile_ms = _sync_ms(lambda: api.build(
        spec, W1A8, params=params, img_hw=40, name="svhn").compile(
        target="cuda", batch_hints=(1, 8)))
    primary.save(os.path.join(work, "svhn_w1a8"))
    loaded, load_ms = _sync_ms(lambda: api.load(
        os.path.join(work, "svhn_w1a8"), quant=W1A8, model="svhn",
        backend="cuda", device="cuda"))
    rs = np.random.RandomState(5)
    images = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
              for _ in range(RES_SVHN_REQUESTS)]
    x = torch.from_numpy(np.stack(images[:8])).to(dev)
    check(torch.equal(loaded.forward(x), primary.forward(x)),
          "reloaded plan's logits differ from the fresh compile's")
    check(loaded.fingerprint() == primary.fingerprint(),
          "reloaded plan's fingerprint differs")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    smoke = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.plan_smoke", "--device",
         "cuda", "--out", os.path.join(work, "plan_smoke")],
        env=env, capture_output=True, text=True, timeout=300)
    smoke_s = time.perf_counter() - t0
    check(smoke.returncode == 0 and "PLAN SMOKE OK" in smoke.stdout,
          f"plan_smoke --device cuda failed: {smoke.stdout[-2000:]} "
          f"{smoke.stderr[-2000:]}")
    cold = {}
    for mode in ("compile", "load"):
        p = subprocess.run(
            [sys.executable, "-c", RES_COLD_PLAN, mode,
             os.path.join(work, "svhn_w1a8")],
            env=env, capture_output=True, text=True, timeout=300)
        check(p.returncode == 0, f"cold svhn W1A8 {mode} failed: "
                                 f"{p.stdout[-2000:]} {p.stderr[-2000:]}")
        cold[mode] = json.loads(p.stdout.strip().splitlines()[-1])
        check(cold[mode]["fingerprint"] == primary.fingerprint(),
              f"cold svhn W1A8 {mode}: fingerprint {cold[mode]} differs")

    def study(c_ms, l_ms):
        # the resume study at an MTBF where a replan is possible but costly
        # (3x the compile), frames a tenth of the compile
        r = plan_resume_study(compile_us=1e3 * c_ms, plan_load_us=1e3 * l_ms,
                              mtbf_us=3e3 * c_ms, frame_time_us=1e2 * c_ms)
        return dict(compile_ms=c_ms, load_ms=l_ms,
                    efficiency_gain=r["efficiency_gain"],
                    recompile_efficiency=r["recompile"]["efficiency"],
                    reload_efficiency=r["plan_reload"]["efficiency"],
                    mtbf_us=3e3 * c_ms, frame_time_us=1e2 * c_ms)

    # a node back from a power loss starts a fresh process: the cold
    # compile and load are each the first of their process; this process
    # is warm from the phases before
    report["plan"] = dict(
        compile_ms=compile_ms, load_ms=load_ms,
        fingerprint=primary.fingerprint(), reload_bit_identical=True,
        plan_smoke_ok=True, plan_smoke_wall_s=smoke_s,
        plan_resume_study=dict(
            cold=study(cold["compile"]["ms"], cold["load"]["ms"]),
            warm=study(compile_ms, load_ms)))

    # ---- resilient CNN serving with a degrade to the faithful W1A1 plan
    fallback = api.build(spec, dataclasses.replace(W1A1, engine="faithful"),
                         params=params, img_hw=40).compile(
        target="cuda", batch_hints=(1, 8))
    plain = {}
    for i, c in enumerate((primary, fallback)):
        plain[i] = [r.value for r in ServeEngine(
            CNNRunner(c.plan), max_batch=8).serve(images)]
    dep = primary.serve(max_batch=8, resilience=ResilienceConfig(
        fault_plan=FaultPlan.scripted(RES_CNN_FAULTS),
        degrade=DegradePolicy(fault_window=4, fault_threshold=2)),
        fallback=fallback)
    eng = dep.engine
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    res = eng.serve(images)
    torch.cuda.synchronize()
    cnn_s = time.perf_counter() - t0
    launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
    check(len(res) == RES_SVHN_REQUESTS and not eng.dead_letters,
          f"resilient svhn: {len(res)} answers, {eng.dead_letters}")
    for r in res:
        check(np.array_equal(r.value, plain[eng.result_runner[r.rid]][r.rid]),
              f"resilient svhn request {r.rid}: logits differ from the plain "
              f"engine's on plan {eng.result_runner[r.rid]}")
    st = eng.stats
    want = dict(faults=2, power_losses=1, device_drops=1, staging_retries=1,
                degrades=1, retries=16, dispatches=4, requests=32)
    got = {k: st[k] for k in want}
    check(got == want, f"resilient svhn counters {got} != {want}")
    by_runner = [sum(v == i for v in eng.result_runner.values())
                 for i in (0, 1)]
    check(by_runner == [8, 24], f"answers per plan {by_runner}")
    want_l = dict(conv_implicit=5, fused_qgemm=1, quantize_pack=18,
                  bitgemm_packed=18)
    check(launches == want_l, f"resilient svhn launches {launches} != "
                              f"{want_l}")
    report["cnn"] = dict(
        requests=RES_SVHN_REQUESTS, answers_by_plan=by_runner,
        counters=got, energy_pj=st["energy_pj"], wall_s=cnn_s,
        launches=launches, bit_identical=True)
    del eng, dep, loaded

    # ---- full-width SmolLM-360M: a decode resumed from its epoch commit
    cfg = dataclasses.replace(get_config("smollm-360m"), quant=W1A8)
    lm_params = prequantize_params(T.init_lm(
        torch.Generator(device=dev).manual_seed(4), cfg, SINGLE), cfg)
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, cfg.vocab, RES_LM_PROMPT).astype(np.int32)
               for _ in range(RES_LM_BATCH)]

    def lm_engine(faults=None, ckdir=None):
        return ResilientServeEngine(
            EpochLMRunner(lm_params, cfg, new_tokens=RES_LM_NEW,
                          epoch_steps=RES_LM_EPOCH),
            fault_plan=faults, checkpoint_dir=ckdir, max_batch=RES_LM_BATCH)

    (ref_res, ref_ms) = _sync_ms(lambda: lm_engine().serve(prompts))
    eng = lm_engine(FaultPlan.scripted([RES_LM_KILL]),
                    os.path.join(work, "decode"))
    _lib.reset_launches()
    lm_res, lm_ms = _sync_ms(lambda: eng.serve(prompts))
    lm_launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
    st = eng.stats
    check(st["resumes"] == 1 and st["prefills"] == 1
          and st["power_losses"] == 1,
          f"resumed decode counters {st}")
    for a, b in zip(lm_res, ref_res):
        check(a.value.shape == (RES_LM_NEW,) and np.array_equal(a.value,
                                                                b.value),
              f"resumed decode request {a.rid}: tokens differ from the "
              "fault-free run's")
    report["lm_decode"] = dict(
        batch=RES_LM_BATCH, prompt_len=RES_LM_PROMPT, new_tokens=RES_LM_NEW,
        epoch_steps=RES_LM_EPOCH, resumes=st["resumes"],
        commits=st["commits"], bytes_per_commit=st["commit_bytes"]
        / st["commits"], commit_s_per_commit=st["commit_s"] / st["commits"],
        epochs=st["epochs"], executed_steps=st["executed_steps"],
        fault_free_ms=ref_ms, faulted_ms=lm_ms, launches=lm_launches,
        bit_identical=True)
    del eng

    # ---- the continuous engine: a power loss, resumed from its commit
    rs = np.random.RandomState(7)
    payloads = [(rs.randint(0, cfg.vocab, int(rs.randint(16, 49)))
                 .astype(np.int32), int(rs.randint(4, 13)))
                for _ in range(RES_CONT_REQUESTS)]

    def cont(**kw):
        return ContinuousLMEngine(lm_params, cfg, num_slots=RES_CONT_SLOTS,
                                  page_size=CONT_PAGE,
                                  num_pages=RES_CONT_PAGES, max_seq=64,
                                  new_tokens=8, **kw)

    c_ref, c_ref_ms = _sync_ms(lambda: cont().serve(payloads))
    c_plain = cont(reference=True, record_margins=True).serve(payloads)
    ceng = cont(checkpoint_dir=os.path.join(work, "continuous"),
                epoch_steps=RES_CONT_EPOCH,
                faults=FaultPlan.scripted([RES_CONT_KILL]))
    _lib.reset_launches()
    c_res, c_ms = _sync_ms(lambda: ceng.serve(payloads))
    c_launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
    cs = ceng.stats
    check(cs["power_losses"] == 1 and cs["commits"] >= 1,
          f"continuous counters {cs}")
    check([r.rid for r in c_res] == [r.rid for r in c_ref],
          "continuous: resumed run answered other requests")
    check([r.rid for r in c_plain] == [r.rid for r in c_ref],
          "continuous: the plain versions' run answered other requests")
    vs_plain = dict(positions=0, divergences=[])
    for a, b, p in zip(c_res, c_ref, c_plain):
        check(np.array_equal(a.value, b.value),
              f"continuous request {a.rid}: tokens differ from the "
              "fault-free run's")
        # attn_paged at this phase's grid and page split, against its
        # plain version
        h = _hold_tokens(f"resumed continuous request {a.rid} vs plain",
                         a.value, p.value, p.margins)
        vs_plain["positions"] += h["positions"]
        vs_plain["divergences"] += [dict(d, request=a.rid)
                                    for d in h["divergences"]]
    check(c_launches.get("attn_paged", 0) == cfg.n_layers
          * cs["dispatches"], f"continuous launches {c_launches}")
    report["continuous"] = dict(
        requests=RES_CONT_REQUESTS, slots=RES_CONT_SLOTS,
        pages=RES_CONT_PAGES, epoch_steps=RES_CONT_EPOCH,
        power_losses=cs["power_losses"], commits=cs["commits"],
        bytes_per_commit=cs["commit_bytes"] / cs["commits"],
        commit_s_per_commit=cs["commit_s"] / cs["commits"],
        steps=cs["steps"], dispatches=cs["dispatches"],
        fault_free_ms=c_ref_ms, faulted_ms=c_ms, launches=c_launches,
        bit_identical=True, vs_plain=vs_plain)
    del ceng
    shutil.rmtree(work, ignore_errors=True)
    print("RESILIENCE", json.dumps(report), flush=True)
    return report


class _CountCalls:
    """Wrap a function and count its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _autotune_rows(plan) -> list:
    """One row per (quantized layer, batch hint): every candidate's
    microseconds, the verdict and where it came from."""
    from repro_torch.kernels import ops

    rows = []
    for lp in plan.layers:
        if lp.fp:
            continue
        for b, eng in lp.engines:
            key = ops.autotune_key(
                b * lp.out_h * lp.out_w, lp.k, lp.cout, lp.a_bits, lp.w_bits,
                "cuda", ops.ConvShape(lp.in_h, lp.in_w, lp.kh, lp.kw,
                                      lp.stride, lp.padding, batch=b))
            verdict, us = plan.autotune.get(key, (eng, {}))
            check(verdict == eng, f"{lp.name} batch {b}: plan engine {eng} "
                                  f"!= measured verdict {verdict}")
            rows.append(dict(layer=lp.name, batch=b, k=lp.k, n=lp.cout,
                             candidates_us=us, verdict=eng,
                             engine_source=lp.engine_source))
    return rows


def _cnn_autotune(tag, spec, q, params, img, hints, x, work, counter,
                  head=None) -> tuple:
    """Compile ``spec`` at ``q`` with and without autotune on the card;
    hold the autotuned plan's output to the heuristic plan's bit for bit
    (the logits, and with ``head`` the first ``head`` layers' output);
    save it, clear the autotune state and reload it, counting the
    measurements of each step.  Returns (report, autotuned, heuristic)."""
    from repro_torch import api
    from repro_torch.core import plan as P
    from repro_torch.kernels import ops

    ops.clear_plan_state()
    model = api.build(spec, q, params=params, img_hw=img, name=tag)
    c0 = counter.calls
    tuned, tuned_ms = _sync_ms(lambda: model.compile(
        target="cuda", batch_hints=hints, autotune=True))
    measured = counter.calls - c0
    heur, heur_ms = _sync_ms(lambda: model.compile(target="cuda",
                                                   batch_hints=hints))
    check(tuned.plan.autotune and all(k[-1] == "cuda"
                                      for k in tuned.plan.autotune),
          f"{tag} {q.tag()}: autotune keys {list(tuned.plan.autotune)}")
    got, want = tuned.forward(x), heur.forward(x)
    check(torch.equal(got, want), f"{tag} {q.tag()}: autotuned logits "
                                  "differ from the heuristic plan's")
    out = dict(compile_ms_autotune=tuned_ms, compile_ms_heuristic=heur_ms,
               autotune_added_ms=tuned_ms - heur_ms,
               time_engine_calls=measured, logits_bit_identical=True,
               layers=_autotune_rows(tuned.plan))
    if head is not None:
        fa = P.execute_cnn_layers(P.layers_for_batch(tuned.plan, 8)[:head],
                                  tuned.params[:head], x, q)
        fb = P.execute_cnn_layers(P.layers_for_batch(heur.plan, 8)[:head],
                                  heur.params[:head], x, q)
        check(torch.equal(fa, fb), f"{tag} {q.tag()}: fc5 output differs "
                                   "from the heuristic plan's")
        out["fc5_bit_identical"] = True
    path = tuned.save(os.path.join(work, f"{tag}_{q.tag()}"))
    ops.clear_plan_state()
    c0 = counter.calls
    back, load_ms = _sync_ms(lambda: api.load(path, quant=q, model=tag,
                                              backend="cuda", device="cuda"))
    check(counter.calls == c0, f"{tag} {q.tag()}: the reload measured "
                               f"{counter.calls - c0} times")
    check([lp.engines for lp in back.plan.layers]
          == [lp.engines for lp in tuned.plan.layers],
          f"{tag} {q.tag()}: reloaded engines differ")
    check(torch.equal(back.forward(x), want),
          f"{tag} {q.tag()}: reloaded logits differ")
    out.update(reload_ms=load_ms, reload_time_engine_calls=0,
               reload_engines_equal=True)
    return out, tuned, heur


def plan_phase(card: str, lm: dict) -> dict:
    """Execution plans on the card: CNN autotune at full width (svhn
    W1A1/W1A4/W1A8, AlexNet W1A1/W1A8), each autotuned plan held to the
    heuristic one and reloaded without a measurement, a serving window of
    the autotuned svhn W1A1 plan beside the heuristic one, and the
    SmolLM-360M W1A8 LM plan through build -> compile -> serve, save and
    load, its tokens held to ``lm_main_path``'s plan-free run, with the
    signed engines autotuned at its four GEMM shapes."""
    import dataclasses
    import shutil

    from repro_torch import api
    from repro_torch.configs import SINGLE, get_config
    from repro_torch.core import plan as P
    from repro_torch.core.quant import PAPER_CONFIGS, W1A8
    from repro_torch.kernels import _lib, ops
    from repro_torch.models import transformer as T
    from repro_torch.models.cnn import alexnet_spec, init_cnn, svhn_cnn_spec

    dev = torch.device("cuda")
    work = os.path.join(ROOT, "build", "plan_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counter = _CountCalls(ops._time_engine)
    ops._time_engine = counter
    report = dict(card=card, cnn={})
    t_phase = time.perf_counter()
    _lib.reset_launches()
    try:
        rs = np.random.RandomState(1)
        images = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
                  for _ in range(16)]
        x_alex = torch.from_numpy(
            rs.uniform(0, 1, (8, 224, 224, 3)).astype(np.float32)).to(dev)
        x_svhn = torch.from_numpy(np.stack(images[:8])).to(dev)
        spec = svhn_cnn_spec()
        svhn_params = init_cnn(torch.Generator(device=dev).manual_seed(0),
                               spec)
        w1a1 = {}
        for qn in PLAN_SVHN_QUANTS:
            out, tuned, heur = _cnn_autotune(
                "svhn", spec, PAPER_CONFIGS[qn], svhn_params, 40,
                PLAN_SVHN_HINTS, x_svhn, work, counter)
            one = torch.from_numpy(images[8][None]).to(dev)
            check(torch.equal(tuned.forward(one), heur.forward(one)),
                  f"svhn {qn}: batch-1 logits differ")
            report["cnn"][f"svhn {qn}"] = out
            if qn == "w1a1":
                w1a1 = dict(autotuned=tuned, heuristic=heur)
        alex_params = init_cnn(torch.Generator(device=dev).manual_seed(1),
                               alexnet_spec())
        for qn in PLAN_ALEX_QUANTS:
            out, _, _ = _cnn_autotune(
                "alexnet", alexnet_spec(), PAPER_CONFIGS[qn], alex_params,
                224, PLAN_ALEX_HINTS, x_alex, work, counter, head=6)
            report["cnn"][f"alexnet {qn}"] = out
        del alex_params, x_alex
        # the faithful question end to end: one serving window each (a
        # report, not a gate)
        windows = {}
        for name, c in w1a1.items():
            dep = c.serve(max_batch=8)
            dep.predict(images[:8])                   # warm-up
            windows[name], vals = serve_window(dep.engine, images)
            check(all(np.isfinite(v).all() for v in vals),
                  f"svhn w1a1 {name} window: non-finite logits")
            windows[name]["engines"] = {
                lp.name: lp.engine_at(8) for lp in c.plan.layers}
        windows["autotuned_over_heuristic_requests_per_s"] = (
            windows["autotuned"]["requests_per_s"]
            / windows["heuristic"]["requests_per_s"])
        report["svhn_w1a1_window"] = windows
        del w1a1
        report["cnn_s"] = time.perf_counter() - t_phase

        # ---- the LM plan at full width
        t_lm = time.perf_counter()
        cfg = dataclasses.replace(get_config("smollm-360m"), quant=W1A8)
        params = T.init_lm(torch.Generator(device=dev).manual_seed(2), cfg,
                           SINGLE)
        ops.clear_plan_state()
        compiled, compile_ms = _sync_ms(lambda: api.build(
            cfg, params=params).compile(
            target="cuda", prompt_len=LM_PROMPT, batch_hints=(LM_BATCH,),
            page_size=CONT_PAGE, kv_pages=PLAN_KV_PAGES))
        del params
        plan = compiled.plan
        kn = sorted({k[1:3] for k in plan.dense_table})
        check(kn == sorted(LM_INT8_GEMMS),
              f"LM dense table (K, N) keys {kn} != {sorted(LM_INT8_GEMMS)}")
        flash_key = ops.attn_plan_key(ops.AttnShape(
            seq_q=LM_PROMPT, seq_kv=LM_PROMPT, heads=cfg.n_heads,
            head_dim=cfg.hd, quantized=True), "cuda")
        paged_key = ops.attn_plan_key(ops.AttnShape(
            seq_q=1, seq_kv=CONT_PAGE * PLAN_KV_PAGES, heads=cfg.n_heads,
            head_dim=cfg.hd, quantized=True, page_size=CONT_PAGE), "cuda")
        check(plan.attn_table == {flash_key: "flash", paged_key: "paged"},
              f"LM attention table {plan.attn_table}")
        hold = lm["bucket_run"]

        def serve_plan(c, tag):
            before = dict(_lib.LAUNCHES)
            dep = c.serve(new_tokens=LM_NEW, max_batch=LM_BATCH)
            d0 = dep.stats["dispatches"]
            toks, ms = _sync_ms(lambda: np.stack(dep.predict(
                hold["prompts"])))
            disp = dep.stats["dispatches"] - d0
            got = {k: _lib.LAUNCHES[k] - before.get(k, 0)
                   for k in _lib.LAUNCHES}
            check(disp == 1, f"LM plan {tag}: {disp} dispatches")
            check(got.get("attn_flash", 0) == cfg.n_layers,
                  f"LM plan {tag}: {got.get('attn_flash', 0)} attn_flash "
                  f"launches for one bucket prefill, want {cfg.n_layers}")
            check(got.get("attn_paged", 0) == 0,
                  f"LM plan {tag}: attn_paged launched")
            return dict(wall_ms=ms, attn_flash_per_prefill=got["attn_flash"],
                        vs_plan_free=_hold_tokens(
                            f"LM plan {tag} vs plan-free", toks,
                            hold["tokens"], hold["margins"]))

        served = serve_plan(compiled, "compiled")
        path = compiled.save(os.path.join(work, "smollm_w1a8"))
        loaded, load_ms = _sync_ms(lambda: api.load(path, spec=cfg,
                                                    device="cuda"))
        check(loaded.fingerprint() == compiled.fingerprint(),
              "LM plan: reloaded fingerprint differs")
        reloaded = serve_plan(loaded, "reloaded")
        # the signed engines timed at the four GEMM shapes
        ops.clear_plan_state()
        c0 = counter.calls
        tuned, tune_ms = _sync_ms(lambda: P.compile_lm(
            plan.params, cfg, prompt_len=LM_PROMPT, batch_hints=(LM_BATCH,),
            autotune=True))
        autotune = {f"{k[2]}x{k[3]}": dict(m=k[1], us=v[1], verdict=v[0])
                    for k, v in sorted(tuned.autotune.items())}
        check(len(autotune) == len(LM_INT8_GEMMS)
              and all(set(r["us"]) == {"f32dot", "int8"}
                      for r in autotune.values()),
              f"LM autotune {autotune}")
        report["lm"] = dict(
            model=cfg.name, quant=cfg.quant.tag(), compile_ms=compile_ms,
            load_ms=load_ms, fingerprint=compiled.fingerprint(),
            dense_table={f"{k[1]}x{k[2]}": v
                         for k, v in sorted(plan.dense_table.items())},
            attn_table={json.dumps(list(k)): v
                        for k, v in plan.attn_table.items()},
            served=served, reloaded=reloaded, autotune_ms=tune_ms,
            autotune_time_engine_calls=counter.calls - c0,
            autotune=autotune, kv_pages=PLAN_KV_PAGES, page_size=CONT_PAGE)
        del compiled, loaded, tuned, plan
        report["lm_s"] = time.perf_counter() - t_lm
    finally:
        ops._time_engine = counter.fn
        ops.clear_plan_state()
    launches = dict(_lib.LAUNCHES)
    for k in PLAN_KERNELS:
        check(launches.get(k, 0) > 0, f"plan phase: {k} never launched")
    report["launches"] = launches
    report["phase_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    print("PLAN", json.dumps(report), flush=True)
    return report


def lm_profiles(params, cfg, layers, cont_engine) -> dict:
    """One decode step of each LM engine under the profiler: the bucket
    engine's (batch LM_BATCH at position LM_PROMPT, attention over the
    full cache) and the continuous engine's (CONT_SLOTS slots, each past a
    prompt of half the longest, 128 tokens).  Each step rewrites the same cache slot, so the
    repeats do the same work."""
    from repro_torch.configs import SINGLE
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    cache = T.init_cache(cfg, SINGLE, LM_BATCH, LM_PROMPT + LM_NEW,
                         device=dev)
    cache["attn"]["pos"][:, :, :LM_PROMPT] = torch.arange(
        LM_PROMPT, dtype=torch.int32, device=dev)
    tok = torch.ones((LM_BATCH, 1), dtype=torch.int32, device=dev)
    out = {"bucket_decode_step": profile_forward(
        lambda: T.decode_step(params, cache, tok, LM_PROMPT, cfg, SINGLE,
                              layers=layers), 3)}
    del cache
    eng = cont_engine()
    n = CONT_PROMPTS[1] // 2
    for i in range(CONT_SLOTS):
        eng.submit((np.full(n, i + 1, np.int32), CONT_HORIZONS[1]))
    eng._admit()
    toks = np.ones((CONT_SLOTS, 1), np.int32)
    pos = np.full((CONT_SLOTS,), n, np.int32)
    valid = np.ones((CONT_SLOTS,), np.int32)
    out["continuous_decode_step"] = profile_forward(
        lambda: eng._dispatch(eng._table, toks, pos, valid), 3)
    return out


PORT_KERNELS = ("fused_qgemm", "conv_implicit", "attn_flash", "attn_paged",
                "quantize_pack", "bitgemm_packed", "int8_matmul")


def _kernel_label(name: str) -> str:
    """The port kernel a device kernel belongs to (``attn_flash`` and
    ``attn_paged`` launch several: ``attn_paged_scales_kernel``...)."""
    for k in PORT_KERNELS:
        if f"{k}_" in name and "_kernel" in name:
            return k
    return name[:70]


def profile_forward(fn, iters: int) -> dict:
    """Where one forward's time goes: host wall per forward (without the
    profiler), device busy time per forward from ``torch.profiler``'s
    kernel records, the idle share between them, and the kernels that
    take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / iters
    if busy_ms == 0.0:
        return dict(wall_ms_per_forward=wall_ms,
                    device_busy_ms_per_forward="not measured")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    port = {}
    for e in kern:
        label = _kernel_label(e.key)
        if label in PORT_KERNELS:
            ms, calls = port.get(label, (0.0, 0.0))
            port[label] = (ms + e.self_device_time_total / 1e3 / iters,
                           calls + e.count / iters)
    return dict(
        iters=iters, wall_ms_per_forward=wall_ms,
        device_busy_ms_per_forward=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        launches_per_forward=sum(e.count for e in kern) / iters,
        port_kernels={k: dict(ms_per_forward=ms, launches_per_forward=calls,
                              share_of_device=ms / busy_ms)
                      for k, (ms, calls) in port.items()},
        top_kernels=[dict(name=_kernel_label(e.key),
                          ms_per_forward=e.self_device_time_total / 1e3 / iters,
                          calls_per_forward=e.count / iters) for e in top])


def kernels_line(summary: dict, launches: dict) -> dict:
    meta = {
        "fused_qgemm": ("src/repro_torch/csrc/fused_qgemm.cu",
                        "src/repro/kernels/fused_qgemm.py:134",
                        "one W1A8 launch at each batch-8 main-path shape"),
        "conv_implicit": ("src/repro_torch/csrc/conv_implicit.cu",
                          "src/repro/kernels/conv_implicit.py:150",
                          "one W1A8 launch at each batch-8 main-path shape"),
        "attn_flash": ("src/repro_torch/csrc/attn_flash.cu",
                       "src/repro/kernels/attn_flash.py:361",
                       "one bf16 call at each LM main-path shape"),
        "attn_paged": ("src/repro_torch/csrc/attn_paged.cu",
                       "src/repro/kernels/attn_flash.py:602",
                       "one bf16 call at each LM main-path shape"),
        "quantize_pack": ("src/repro_torch/csrc/quantpack.cu",
                          "src/repro/kernels/quantpack.py:57",
                          "one 4-bit launch, float in and levels in, at each "
                          "batch-8 faithful-path activation shape"),
        "bitgemm_packed": ("src/repro_torch/csrc/bitgemm.cu",
                           "src/repro/kernels/bitgemm.py:80",
                           "one launch at each batch-8 faithful-path shape, "
                           "svhn at W1A1 and W1A4, AlexNet at W1A1"),
        "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                        "src/repro/kernels/bitgemm_mxu.py:65",
                        "one launch (one W1A8 nibble group) at each batch-8 "
                        "int8-path shape"),
    }
    out = []
    for name, rows in summary.items():
        timed = [r for r in rows if "ms" in r and r.get("main_path", True)]
        tot = {k: sum(r[k] for r in timed)
               for k in ("ms", "plain_ms", "bound_ms")}
        lib = [r["library_ms"] for r in timed]
        tot["library_ms"] = None if None in lib else sum(lib)
        bound_by = ("bytes" if sum(r["bound_ms"] for r in timed
                                   if r["bound_by"] == "bytes")
                    >= tot["bound_ms"] / 2 else "operations")
        src, replaces, timed_over = meta[name]
        entry = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches.get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=bound_by, library_ms=tot["library_ms"],
            timed_over=timed_over)
        if name == "bitgemm_packed":
            entry["popc_floor_ms"] = sum(r["popc_floor_ms"] for r in timed)
        if name == "quantize_pack":
            entry["library_call"] = timed[0]["library_call"]
            entry["by_form"] = {
                form: {k: sum(r[k] for r in timed if r["form"] == form)
                       for k in ("ms", "bound_ms", "plain_ms", "copy_ms")}
                for form in ("float in", "levels in")}
        if (name in ATTN_MAX_DEVICE_OPS or name in CNN_MAX_DEVICE_OPS
                or name in BIT_MAX_DEVICE_OPS):
            entry["device_ops_per_call"] = max(r["device_ops_per_call"]
                                               for r in timed)
        entry["shapes"] = [
            {k: r[k] for k in ("model", "layer", "case", "main_path", "shape",
                               "a_bits", "form", "ms", "plain_ms",
                               "copy_ms", "bound_ms", "bound_by",
                               "popc_floor_ms",
                               "library_ms", "library_call",
                               "device_ops_per_call") if k in r}
            for r in rows if "ms" in r]
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print("CARD", card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    _lib.build_all()
    print(f"BUILD {time.perf_counter() - t0:.1f} s "
          + json.dumps({k: round(v, 1) for k, v in _lib.BUILD_SECONDS.items()}))
    for name, log in _lib.BUILD_LOG.items():
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"PTXAS {name}: {line.strip()}")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    summary = kernel_phase(flush)
    t1 = time.perf_counter()
    summary.update(bitplane_kernel_phase(flush))
    t2 = time.perf_counter()
    summary.update(lm_kernel_phase(flush))
    print(f"KERNEL PHASES cnn {t1 - t0:.1f} s, bit-plane {t2 - t1:.1f} s, "
          f"lm {time.perf_counter() - t2:.1f} s", flush=True)
    del flush
    if "--kernels-only" in sys.argv[1:]:
        print("KERNELS-ONLY done", flush=True)
        return 0
    t0 = time.perf_counter()
    report = main_path(card)
    launches = {k: report["launches"][k] for k in ("fused_qgemm",
                                                    "conv_implicit")}
    print(f"CNN MAIN PATH {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    bit = bitplane_main_path(card)
    launches.update({k: bit["launches"][k] for k in ("quantize_pack",
                                                      "bitgemm_packed",
                                                      "int8_matmul")})
    print(f"FAITHFUL/INT8 MAIN PATH {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    lm = lm_main_path(card)
    launches.update({k: lm["launches"][k] for k in ("attn_flash",
                                                     "attn_paged")})
    print(f"LM MAIN PATH {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    resilience_phase(card)
    print(f"RESILIENCE PHASE {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    plan_phase(card, lm)
    print(f"PLAN PHASE {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(kernels_line(summary, launches)))
    print(f"TOTAL {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

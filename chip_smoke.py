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
   the norm kernel (``norm_act``) at the seven hidden-layer shapes of the
   benchmark's svhn net (width 20, 40x40) at batch 1024, held to its plain
   version (levels within one, at most 1e-4 of them differing: only the
   statistics' summation order differs) and timed beside its bytes bound
   (4 bytes read and 4 written an element) and the plain version, with
   its launches in one forward of that net at batch 1024; held the same
   way, untimed, at the hidden-layer shapes of the full-width svhn net
   (width 64: clusters up to 5) and of AlexNet (224x224: clusters up to
   6, and 1x1 maps) at batch 8;
4. CNN main path: through ``build -> compile(target="cuda") ->
   serve(max_batch=8)`` at W1A4 and W1A8, full-width svhn answers a
   16-request correctness set three times over (logits equal to the
   plain versions' within a tolerance, as the norm kernel's statistics
   sum in another order, and exactly equal with the norm's plain version
   in the kernel's place, which holds every other kernel bit for bit;
   alone vs batched within the tolerance too), then serves
   a closed loop of 32 outstanding requests for a 4 s window, the
   serving measurement; full AlexNet runs one 224x224 W1A8 forward at
   batch 8 with the same checks; the launch counts are checked;
4b. the faithful and int8 engines' main path: the same svhn through
   ``build -> compile(target="cuda") -> serve(max_batch=8)`` with
   ``engine="faithful"`` at W1A1 and W1A4 and ``engine="int8"`` at W1A8
   answers the 16-request set three times; its logits equal the default
   engines' (fused/implicit) exactly, the plain versions' within the
   tolerance and exactly with the norm's plain version in the kernel's
   place, and alone vs batched within the tolerance; 4 s serving windows
   for faithful W1A1
   and int8 W1A8 (and, outside the counted run, default W1A1); AlexNet
   W1A1 faithful at batch 8 (fc5's output and the logits equal the
   default engines' exactly, and the plain versions' as the svhn logits
   do); the launch counts are checked (6 ``quantize_pack`` + 6
   ``bitgemm_packed`` per faithful dispatch, 12 ``int8_matmul`` per int8
   dispatch, 7 ``norm_act`` per dispatch, no ``fused_qgemm`` or
   ``conv_implicit``); then ``quant_dense_kernel`` on AlexNet fc5's shape,
   both paths equal to each other and to the plain versions, with 1
   ``quantize_pack`` and 1 ``bitgemm_packed`` or ``int8_matmul`` launch;
4c. the legacy served CNN entry point and the paper's spec walk, one
   ``SPEC`` line: ``models.cnn.cnn_forward(params, x, spec, quant,
   "serve")`` (its cached per-call plan, ``core.plan.cnn_serve_layers``)
   on the card at full width, batch 8: svhn W1A4 and W1A8, AlexNet
   224x224 W1A8 and svhn W1A1 on ``engine="faithful"``, each called twice
   from float params (prequantized at the call) and once from the
   compiled plan's params; every call's launches counted alone (5
   ``conv_implicit`` + 1 ``fused_qgemm`` for svhn, 4 + 2 for AlexNet, 6
   ``quantize_pack`` + 6 ``bitgemm_packed`` faithful, and 7 ``norm_act``
   each, nothing else), the logits (and AlexNet's fc5 output) bit for bit
   those of ``api.build(...).compile(batch_hints=(8,)).forward``, within
   the tolerance of the plain versions' and bit for bit those with the
   norm's plain version in the kernel's place; host ms of one call
   (median of 5) beside the compiled forward's; ``pim.mapper.model_work`` equal to ``works_from_layers`` of
   the plans compiled for ``cuda``, ``compare_designs`` for AlexNet W1A1
   (figures of the paper's PIM model, not of the card) and
   ``serve_weight_bytes`` of the svhn plan's params against the float
   params;
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
   ``quantize_pack``, ``bitgemm_packed`` and ``norm_act`` (7 a
   dispatch) launch; full-width
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
5c2. static verification, one ``ANALYSIS`` line: every plan the script
   compiles (or reloads) is proven as it is compiled (``verify=True``,
   the default; PV101-PV108 against the Hopper kernels' bounds): the
   count, their violations (must be 0) and ``verify_plan`` ms for the
   SmolLM-360M plan and the largest families plan (each family's plan is
   compiled here at full width, one pattern period deep: a plan has one
   row per GEMM shape and attention geometry, whatever the depth); the
   svhn, AlexNet and SmolLM-360M W1A8 plans saved and proven by
   ``python -m repro_torch.analysis check-plan`` in a subprocess (exit
   0), an AlexNet artifact hand-edited (fc6 pinned to ``implicit``)
   refused by it (exit 1, PV103) and by ``compile(cache=...)``
   (``PlanVerificationError``, no launch); at each boundary of the
   prover (``fused_qgemm`` W8A8 int32 K, ``int8_matmul``'s s8 K,
   ``conv_implicit``'s shared memory, ``attn_flash``'s head dims,
   ``attn_paged``'s shared memory) the shape just inside is proven, its
   kernel launches and equals its plain version (bit for bit for the
   integer kernels), and the shape just outside is refused by the prover
   and by the kernel's wrapper before any launch; ``python -m
   repro_torch.analysis lint src/repro_torch chip_smoke.py`` exits 0 with
   RL004 proving the fourteen ctypes launchers against ``csrc``;
5d. the dense, MoE and recurrent architectures, one ``FAMILIES`` line
   (W1A8, bf16, random weights from FAM_SEED, each model freed before the
   next): phi3-mini-3.8b, granite-moe-3b-a800m, recurrentgemma-9b and
   rwkv6-1.6b at full config, qwen3-32b, yi-34b and deepseek-moe-16b at
   full width and 8 layers (``reduced``: their float32 params do not fit
   beside the working set), each a bucket of two prompts (2048 tokens,
   512 for rwkv6) through ``ServeEngine`` + ``LMRunner``: params GB, init
   and prequantize seconds, prefill ms and tokens/s, the attention engine
   per block kind, launches checked (``attn_flash`` once per attention
   layer of the prefill; none for rwkv6), every kernel call of the run
   held to its plain version on the model's own inputs, each side run
   twice bit for bit, the prefill's last logits moved by the kernels at
   most FAM_GAP_FACTOR x what the plain version at another float order
   moves them, the tokens compared with the plain run (each first
   difference reported with its margin; rwkv6's bucket equals
   ``serve_once`` bit for bit); phi3-mini also serves phase 5's
   continuous mix through ``ContinuousLMEngine`` (``attn_paged`` at hd
   96; launches checked, calls held in context, the in-context rerun's
   tokens the counted run's) and one decode step under the profiler;
   the continuous engine refuses every other pattern; the ``KERNEL`` rows
   of phase 3 include ``attn_flash`` at hd 96 and 256 and ``attn_paged``
   at hd 96 (phi3's decode and chunk shapes, and 128-page tables);
5e. the encoder and VLM families and the fleet simulator: one ``FAMILY``
   line each for hubert-xlarge (full config, 48 layers: 2 x 2048 frames
   of features from FAM_SEED through ``prefill(frame_feats=)``,
   non-causal ``attn_flash`` at hd 80) and internvl2-26b (full width, 8
   of 48 layers, ``reduced``: 2 prompts of 256 patches + 1792 tokens
   through ``prefill(patch_embeds=, tokens=)``, then 8 greedy tokens
   through ``decode_step``), W1A8, bf16: params GB, prefill ms, one
   ``attn_flash`` per layer (48, 8), every kernel call in context, each
   side rerun bit for bit, the logit gap (every frame's logits for
   hubert, the prefill's last for internvl) at most FAM_GAP_FACTOR x the
   reordered plain version's; per-frame argmax agreement and tokens vs
   the plain run reported; the ``KERNEL attn_flash`` rows of phase 3
   include both prefill shapes, (2, 2048, 16, 80) non-causal and (2,
   2048, 48, 128) causal; then one ``FLEET`` line: the seeded 64-node
   fleet study (``repro_torch.fleet``: harvest traces, the co-design
   search, the fleet report), the same study in a fresh CPU-only
   interpreter from the specs' JSON (reports byte-equal), and the
   busiest node's outage schedule replayed through the port's
   ResilientServeEngine on the card (``live_validation(device="cuda")``:
   ok, integer deltas 0, float deltas within 1e-6), with host seconds;
5f. training, one ``TRAIN`` line (deterministic kernels:
   ``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts): the paper's
   svhn CNN at full width (64), W1A4, batch 32, through
   ``IntermittentTrainer`` (4 microbatches a step, snapshots every 2,
   full checkpoints every 2 steps): a golden run of 4 steps and a chaotic
   one with power failures at TRAIN_CNN_FAILS through
   ``run_with_failures`` end with params equal bit for bit on the card;
   the first step's loss and gradients against the same step on the CPU
   (the CPU tests' tolerances, or a pinned level flip); no port kernel
   launched while training; the trained params through ``api.build(...,
   W1A4).compile()`` served on 64 images: ``conv_implicit``,
   ``fused_qgemm`` and ``norm_act`` launch, the logits within the
   tolerance of ``forward(reference=True)`` and bit for bit those with
   the norm's plain version in the kernel's place; SmolLM-360M W1A8 at
   full width through ``Trainer`` for 20
   steps (batch 8, seq 64, lr 3e-3, warmup 5, bf16 compute, remat),
   checkpoints at steps 10 and 20: every loss finite, the last below the
   first, no port kernel launched, a fresh ``Trainer`` restoring step 20
   with params and optimizer state equal bit for bit on the card, then 2
   steps with compressed gradients; the median ms per step over steps
   3-20 (synchronized), one step's host wall against its device time
   (``torch.profiler``), ``torch.cuda.max_memory_allocated`` and the
   phase's seconds;
5g. distributed, one ``DIST`` line: ``launch.mesh.make_serve_mesh()`` is
   None on one card; the data-parallel ``ServeEngine`` over two replicas
   on ``cuda:0`` (a test layout for one card): svhn(64) W1A8, 32 requests
   at ``max_batch=8``, each dispatch two 4-row replica forwards equal to
   the one-device engine at ``max_batch=4`` bit for bit with exactly twice
   a 4-row dispatch's ``conv_implicit``/``fused_qgemm`` launches (the
   plan's 4-row engines) and 7 ``norm_act`` a replica, within the alone-vs-batched tolerance of one
   device's 8-row dispatches, and the two-replica and one-device 4 s
   windows' requests/s side by side; SmolLM-360M W1A8, two 2048-token
   prompts x 16 new tokens, each replica's tokens held to its prompt
   served alone and ``attn_flash`` launched 32 times a replica; in a
   child process a card (``init_process_group("nccl")``, world =
   ``device_count()``), SmolLM-360M W1A8 at full width and depth (bf16,
   remat) for 3 steps through the meshless ``Trainer`` and through
   ``Trainer(mesh=)`` on a ``(world, 1)`` mesh: step 1's gathered
   gradients leaf by leaf, each step's params against the meshless
   optimizer fed the run's own gradients (DIST_STEP_TOL) and the losses;
   at world 1 gradients within 1e-4 x max|g|, losses within 1e-6, params
   within DIST_STEP_TOL of the meshless run's (bit-identity reported);
   split, gradients within DIST_SPLIT_GRAD_TOL, and a planted fault (half
   the batch's gradient) must fail that bound; ms per step, one step's
   profile, launches, peak memory and DTensor's overhead a step;
   ``compressed_allreduce`` over the NCCL group on the
   trainer's gradients, equal to the local path at world 1; with four or
   more cards the trainer at ``(world / 2, 2)``, the pipeline at S = 4
   and the svhn engine over every card (``"not run: 1 card"`` on one);
5h. the dry-run tooling, one ``DRYRUN`` line: ``python -m
   repro_torch.launch.dryrun`` on SmolLM-360M ``train_4k`` (16 x 16) and
   recurrentgemma-9b ``prefill_32k --analysis --multi-pod`` (2 x 16 x 16,
   ``rglru_assoc`` and ``full_attn_analysis`` at full config), each in a
   CPU-only interpreter on a fake process group: exit 0, ``ok`` and the
   reference's keys; ``python -m repro_torch.launch.sweep`` over
   ``smollm-360m:decode_32k`` twice, the second run skipping the cell;
   before them, ``launch.steps.build_cell``'s one-device SmolLM-360M W1A8
   cells on the card (a train step of 8 x 64, a prequantized prefill of
   2 x 2048 with its 32 ``attn_flash`` launches), each run 3 times: their
   ms, ``hlo_analysis.StepCounter``'s flops on the card equal to the same
   cell's on meta, the ``Roofline`` beside the measured time and the
   model flops' share of the bf16 peak; the families phase (5d) also runs
   recurrentgemma-9b's prefill in the parallel RG-LRU form
   (``rglru_assoc``): one recurrent block's float32 h within 1e-5 x
   max|h| of the sequential scan's on the model's own inputs, the last
   logits under the families' witness gate, both prefill times
   (``RGLRU_ASSOC`` line);
6. one JSON line listing the kernels (with the families' and the
   modalities' launches, and the train phase's handoff launches), then
   the contract's last line.

``--kernels-only`` stops after phase 3 (a quick first check of a kernel).
``--phase NAME`` (cnn, bitplane, spec, lm, resilience, plan, analysis,
families, modalities, fleet, train, dist, dryrun) runs the build and that
phase alone (plan after lm, analysis after lm and plan: the phases it
reads), without the kernel phases and the kernels line.
The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the train phase's deterministic mode needs cuBLAS's fixed workspace,
# set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# batch and are held exactly, but for the norm kernel (norm_act), whose
# per-sample statistics sum in another order than the plain version's: a
# forward through it is held to the plain versions by this tolerance too,
# and the same forward with the norm's plain version in its place
# (plain_norm) exactly.
LOGIT_TOL_FRAC = 0.1
# sm_90 issues 16 32-bit population counts per SM per clock (CUDA C++
# Programming Guide, arithmetic instruction throughput): with one AND and
# one add beside each, the floor of the AND + popcount dataflow on the
# CUDA cores
POPC_PER_SM_CLOCK = 16
# the spec phase: its images' seed and each call's launches
SPEC_SEED = 5
SPEC_LAUNCHES = {"svhn": {"conv_implicit": 5, "fused_qgemm": 1,
                          "norm_act": 7},
                 "alexnet": {"conv_implicit": 4, "fused_qgemm": 2,
                             "norm_act": 7},
                 "faithful": {"quantize_pack": 6, "bitgemm_packed": 6,
                              "norm_act": 7}}
# the bit-plane engines' main path: (bit widths, engine), and the ones
# whose 4 s serving window is measured
BITPLANE_PATHS = (("w1a1", "faithful"), ("w1a4", "faithful"),
                  ("w1a8", "int8"))
BITPLANE_WINDOWS = ("w1a1 faithful", "w1a8 int8")
# the norm kernel's row: the benchmark's svhn net at its bucket size
NORM_NAME = "norm_act"
NORM_BATCH = 1024
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

# the families phase: (arch, layers kept or None for all, prompt tokens,
# new tokens, continuous engine too), each served as a bucket of FAM_BATCH
# prompts; the three
# largest at full width but 8 layers (their float32 params at full depth do
# not fit beside the working set on an 80 GB card).  phi3-mini also serves
# the LM main path's continuous request mix (CONT_*) through the
# continuous engine
FAMILIES = (("phi3-mini-3.8b", None, 2048, 16, True),
            ("granite-moe-3b-a800m", None, 2048, 16, False),
            ("recurrentgemma-9b", None, 2048, 16, False),
            ("rwkv6-1.6b", None, 512, 16, False),
            ("qwen3-32b", 8, 2048, 8, False),
            ("yi-34b", 8, 2048, 8, False),
            ("deepseek-moe-16b", 8, 2048, 8, False))
FAM_BATCH, FAM_SEED = 2, 7
# The families' gates.  These per-tensor-quantized networks carry one
# rounding of an attention output into flipped activation levels and MoE
# routes (in float32 compute too: phi3-mini's first token left the plain
# run's at a 0.075 margin on the card), so their tokens are compared with
# the plain run and reported, not held to a margin.  What is held: every
# kernel call in context (``_InContext``); each side run twice, bit for
# bit (a difference sits at the same position every run); and the
# prefill's last logits, which the kernels may move by at most
# FAM_GAP_FACTOR x what the plain version at another float order moves
# them (``_plain_reordered``; 0.85-1.25x on the card).  RWKV-6 runs no
# kernel: its bucket equals ``serve_once`` on the same batch bit for bit.
FAM_GAP_FACTOR = 2.0
# the encoder and VLM families (the modalities phase), with the families'
# batch, seed and gates: hubert-xlarge at full config, FAM_BATCH x
# MOD_FRAMES frames of features; internvl2-26b at full width and
# MOD_VLM_LAYERS of its 48 layers (``reduced``: float32 params at full depth,
# ~80 GB, do not fit), FAM_BATCH prompts of its n_patches patches and
# MOD_TEXT text tokens (2048 positions: the flash route), then MOD_NEW
# greedy tokens through prefill + decode_step
MOD_FRAMES, MOD_VLM_LAYERS, MOD_TEXT, MOD_NEW = 2048, 8, 1792, 8
# the fleet phase: the seeded fleet study of ``repro_torch.fleet`` (one
# day of harvest traces, Table-I SLOs, the co-design search), repeated in
# a fresh CPU-only interpreter from the specs' JSON; then the busiest
# node's first FLEET_OUTAGES outages replayed through the port's
# ResilientServeEngine on the card (``live_validation``)
FLEET_NODES, FLEET_SEED, FLEET_SLO_SEED, FLEET_RESUME_US = 64, 0, 1, 26_000.0
FLEET_REPLAY = dict(n_requests=8, new_tokens=7, epoch_steps=2, max_batch=4)
FLEET_OUTAGES, FLEET_TOL = 6, 1e-6
# the analysis phase: the saved artifacts checked by the CLI (svhn and
# AlexNet W1A8 with batch hints 1 and 8, the LM plan phase's SmolLM-360M
# geometry), the hand edit (AlexNet fc6, a 1x1 conv, pinned to implicit)
# and the prover's boundaries held against the kernels on the card: the
# deep-K implicit conv's image height, channels and depth (K = 9 * 64),
# the attention geometries (flash: 1 x 256 rows x 4 heads; paged: 2 slots
# of 8-page tables, pages of 16, 4 heads)
ANALYSIS_EDIT = ("alexnet", 6, "fused", "implicit")
ANALYSIS_CONV = dict(h=4, cin=64, cout=64)
ANALYSIS_FLASH = dict(b=1, s=256, h=4)
ANALYSIS_PAGED = dict(b=2, p=8, ps=16, h=4, np_=32)

# the dry-run phase: launch.dryrun's cells, each in a CPU-only interpreter
# on a fake process group (no device): SmolLM-360M train_4k on 16 x 16,
# and recurrentgemma-9b prefill_32k with the analysis toggles on 2 x 16 x
# 16 (``constrain_acts``: the residual stream batch-split, without which
# DTensor's sharding propagation on the 3-D mesh takes minutes a block);
# the sweep over one cell, twice (the second run skips it); then
# build_cell's one-device SmolLM-360M W1A8 cells live on the card from
# DRY_SEED: a train step of TRAIN_LM's 8 x 64 and a prequantized serve
# prefill of 2 x 2048 (32 attn_flash), each run DRY_RUNS times, its flops
# on the card equal to the same cell's on meta
DRY_CELLS = (("smollm-360m", "train_4k", ()),
             ("recurrentgemma-9b", "prefill_32k",
              ("--analysis", "--multi-pod", "--set", "constrain_acts=1")))
DRY_SWEEP = "smollm-360m:decode_32k"
DRY_LIVE = (("train", 8, 64, False), ("prefill", 2, 2048, True))
DRY_RUNS, DRY_SEED, DRY_TIMEOUT_S = 3, 11, 600
# the reference's result keys of a dry-run cell
DRY_KEYS = {"arch", "shape", "mesh", "chips", "ok", "lower_s", "compile_s",
            "memory", "collectives", "roofline", "flops", "bytes_accessed"}
# the families phase's recurrentgemma-9b prefill again in the parallel
# form (rglru_assoc): one recurrent block's float32 h held to the
# sequential scan's on the model's own inputs (x max|h|)
RG_ASSOC_H_TOL = 1e-5

# the train phase: the paper's CNN (svhn at full width 64, W1A4, batch
# 32) under power failures through IntermittentTrainer, then served on the
# card's kernels (its 6 quantized convs: 5 on conv_implicit, the 1x1 one
# on fused_qgemm); SmolLM-360M W1A8 at full width trained by Trainer.
# The card-vs-CPU first step is held layer by layer on the CPU's inputs
# to the CPU tests' tolerances (tests/test_torch_train_cnn.py: loss 1e-6,
# gradients 1e-4 x max|g|), every level flip pinned as there: within
# TRAIN_FLIP_MARGIN of a level boundary.  The activations are held at
# 1e-4 of their max too: batch-normed float32 activations sit up to
# 1.1e-5 from float64 on either side (train_precision.py, svhn(64) layer
# 5 on an H100: the card 1.07e-5, the CPU 1.03e-5)
TRAIN_CNN = dict(channels=64, batch=32, steps=4, images=64)
TRAIN_CNN_FAILS = {(1, 3), (2, 1)}
TRAIN_SERVE_LAUNCHES = {"conv_implicit": 5, "fused_qgemm": 1, "norm_act": 7}
TRAIN_ACT_TOL, TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-6, 1e-4
TRAIN_FLIP_MARGIN = 1e-4
# SmolLM's batches: lm_batch's Markov stream over the first data_vocab of
# the model's 49152 tokens; over all of them 20 steps of 512 tokens hold
# no learnable signal (the loss sits at the uniform floor, +-0.02 of
# batch noise), over 512 the loss falls within the 20 steps
TRAIN_LM = dict(steps=20, batch=8, seq=64, lr=3e-3, warmup=5, ckpt_every=10,
                compressed_steps=2, timed_from=3, data_vocab=512)

# the distributed phase: svhn requests over the two-replica engine, the
# NCCL trainer's run (TRAIN_LM's batches, 3 steps), the multi-card
# pipeline's shape and tolerance (x the larger of max|y|, max|dW|).  A mesh
# trainer is held to the meshless trainer on the same params and batches
# three ways: step 1's gathered gradient leaf by leaf (x the leaf's
# max|g|); each step's params within DIST_STEP_TOL of the meshless
# optimizer fed the run's own gathered gradients from the same params (as
# tests/test_torch_dist_train.py holds them); the losses.  At world 1
# (nothing split) the gradients within TRAIN_GRAD_TOL, the losses within
# TRAIN_LOSS_TOL and the params within DIST_STEP_TOL of the meshless run's
DIST_SVHN_REQUESTS = 32
DIST_TRAIN = dict(steps=3, batch=8, seq=64, lr=3e-3, warmup=5,
                  data_vocab=512)
DIST_STEP_TOL = 1e-5
# split over several ranks, each rank's bf16 weight gradient covers its own
# rows and is rounded once (2^-9 of that partial sum), and the ranks'
# partials are summed in bf16 in another order than one device sums them;
# at model > 1 the row-parallel products' partials are rounded and summed
# the same way in the forward, and where such a rounding crosses an 8-bit
# activation level (W1A8) the input moves by a whole level, 1/127 of the
# tensor's max.  So each leaf is held within 2^-3 of its max|g|: the CPU
# rehearsal of this phase (smoke SmolLM, bf16) read 3.8e-3 at (4, 1) and
# 3.5e-2 at (2, 2), four H100s 1.6e-2 and 8.1e-2.  A gradient that missed
# the data all-reduce (one rank's rows alone) is O(1) off: DIST_FAULT_ROWS
# (the first half of the batch) is planted on every run, and over half its
# leaves must exceed the bound (on the H100 every leaf, 0.87 to 1.17 x
# max|g|).  The losses
# within one bf16 rounding (2^-8, relative).  After a step the params are
# not held to the meshless run's: AdamW's first steps move each element by
# about lr x sign(g), so a sign flip in a near-zero element parts the runs
# by up to twice the lr; the optimizer bound above holds each step instead
DIST_SPLIT_GRAD_TOL = 2.0 ** -3
DIST_SPLIT_LOSS_TOL = 2.0 ** -8
DIST_FAULT_ROWS = DIST_TRAIN["batch"] // 2
DIST_PIPE = dict(M=8, mb=4, d=960)
DIST_PIPE_TOL = 2e-5
DIST_CHILD_TIMEOUT_S = 600

FLEET_CPU_RUN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from repro_torch.fleet import TraceSpec
specs = [TraceSpec.from_json(d) for d in json.load(sys.stdin)]
print(json.dumps(chip_smoke.fleet_study(specs)[0], sort_keys=True))
"""


# the step counter's readings on this machine's torch (a CPU-only child:
# argv[1] the repository root), one JSON line
DRY_FACTS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
print(json.dumps(chip_smoke.counter_facts()))
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


def norm_act_kernel_phase(flush: torch.Tensor) -> dict:
    """``norm_act`` against its plain version: timed at the benchmark's
    svhn net (width 20) at batch 1024, the ``kernels`` line's row; held
    alone, untimed, at the full-width svhn net's and AlexNet's hidden
    layers at batch 8, whose slabs take clusters of up to 5 and 6 and
    whose FC layers are 1x1 maps."""
    from repro_torch import api
    from repro_torch.configs.paper_cnn import SVHN_SPEC
    from repro_torch.core import plan as P
    from repro_torch.core.quant import W1A4
    from repro_torch.kernels import _lib
    from repro_torch.kernels.norm_act import (norm_act, norm_act_plain,
                                              plan_for)
    from repro_torch.models.cnn import alexnet_spec, init_cnn, svhn_cnn_spec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    compiled = api.build(SVHN_SPEC, W1A4, params=init_cnn(gen, SVHN_SPEC),
                         img_hw=40).compile(target="cuda",
                                            batch_hints=(NORM_BATCH,))
    x_img = torch.rand((NORM_BATCH, 40, 40, 3), generator=gen, device=dev)
    compiled.forward(x_img)
    torch.cuda.synchronize()
    _lib.reset_launches()
    compiled.forward(x_img)
    torch.cuda.synchronize()
    per_dispatch = _lib.LAUNCHES[NORM_NAME]
    del x_img
    n = (1 << W1A4.a_bits) - 1
    cases = [("svhn20", lp, NORM_BATCH, True)
             for lp in compiled.plan.layers[:-1]]
    for model, spec, hw in (("svhn64", svhn_cnn_spec(), 40),
                            ("alexnet", alexnet_spec(), 224)):
        cases += [(model, lp, 8, False) for lp in P.cnn_serve_layers(
            spec, W1A4, batch=8, img_hw=(hw, hw))[:-1]]
    rows = []
    for model, lp, batch, timed in cases:
        shape = (batch, lp.out_h, lp.out_w, lp.cout)
        x = torch.randn(shape, generator=gen, device=dev)
        b, g, beta = (torch.rand(lp.cout, generator=gen, device=dev) * w + lo
                      for w, lo in ((1.0, -0.5), (0.3, 0.1), (0.4, 0.3)))
        kern = lambda x=x, g=g, beta=beta, b=b: norm_act(x, g, beta, b,
                                                         W1A4.a_bits)
        plain = lambda x=x, g=g, beta=beta, b=b: norm_act_plain(
            x, g, beta, b, W1A4.a_bits)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        d = (torch.round(got * n) - torch.round(ref * n)).abs()
        flips = float((d != 0).float().mean())
        check(float(d.max()) <= 1 and flips <= 1e-4,
              f"norm_act {model} {lp.name}: levels differ from the plain "
              f"version's by {float(d.max())} (share {flips})")
        plan = plan_for(*shape[1:])
        row = dict(model=model, layer=lp.name, shape=list(shape),
                   path=plan.path, cluster=plan.chunks,
                   level_flips_vs_plain=flips,
                   max_abs_err=float((got - ref).abs().max()))
        del got, ref, d
        if timed:
            row["ms"] = time_ms(kern, 30, flush)
            row["plain_ms"] = time_ms(plain, 5, flush)
            # 4 bytes read and 4 written an element, the three vectors once
            row["bound_ms"], row["bound_by"] = bound_ms(
                0.0, 8.0 * x.numel() + 12.0 * lp.cout)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["library_ms"] = None
        row["device_ops_per_call"] = _lib.count_device_ops(kern)
        check(row["device_ops_per_call"] == 1,
              f"norm_act {model} {lp.name}: {row['device_ops_per_call']} "
              f"device operations a call")
        rows.append(row)
        print("KERNEL", json.dumps(row), flush=True)
        del x, kern, plain
    for r in rows:
        r["launches_per_dispatch"] = per_dispatch
    return {NORM_NAME: rows}


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
    # the SmolLM main path's shapes, then the families phase's (phi3-mini's
    # hd 96 prefill, recurrentgemma's windowed hd 256 'attn_local' prefill)
    # and the modalities phase's (hubert-xlarge's non-causal hd 80 prefill
    # of 2048 frames, internvl2-26b's hd 128 prefill of 2048 positions)
    for case, (b, sq, h, hd, window), causal, path in (
            ("bucket prefill", (LM_BATCH, LM_PROMPT, 15, 64, None), True,
             "smollm"),
            ("window 256", (1, LM_PROMPT, 15, 64, 256), True, "smollm"),
            ("phi3-mini prefill hd 96", (FAM_BATCH, 2048, 32, 96, None),
             True, "families"),
            ("recurrentgemma attn_local prefill hd 256",
             (FAM_BATCH, 2048, 16, 256, 2048), True, "families"),
            ("hubert-xlarge prefill hd 80 non-causal",
             (FAM_BATCH, MOD_FRAMES, 16, 80, None), False, "modalities"),
            ("internvl2-26b prefill hd 128",
             (FAM_BATCH, 2048, 48, 128, None), True, "modalities")):
        main = path == "smollm"
        q, k, v = (torch.randn((b, sq, h, hd), generator=gen, device=dev)
                   for _ in range(3))
        kw = dict(causal=causal, window=window)
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
        pairs = b * h * _kept_pairs(sq, causal, window)
        nbytes = 4 * b * sq * h * hd * 2      # q, k, v in, out, bf16
        t = [x.transpose(1, 2).contiguous() for x in (qb, kb, vb)]
        if window:
            i = torch.arange(sq, device=dev)
            mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
            lib = lambda t=t, mask=mask: F.scaled_dot_product_attention(  # noqa: E731
                *t, attn_mask=mask)
        else:
            lib = lambda t=t, c=causal: F.scaled_dot_product_attention(  # noqa: E731
                *t, is_causal=c)
        row = dict(case=case, main_path=main, path=path,
                   shape=[b, sq, h, hd], causal=causal, window=window,
                   max_abs_err=err, tol=tol, max_abs_err_bf16=err_b,
                   tol_bf16=tol_b, bf16_elementwise_worst=elem_b,
                   ms=time_ms(lambda: attn_flash(qb, kb, vb, **kw), 20, flush),
                   plain_ms=time_ms(lambda: attn_flash(
                       qb, kb, vb, reference=True, **kw), 3, flush),
                   library_call="F.scaled_dot_product_attention bf16",
                   library_ms=time_ms(lib, 20, flush),
                   prev_ms=ATTN_PREV_MS.get(case),
                   prev_ms_source=PREV_MS_SOURCE,
                   device_ops_per_call=device_ops(
                       "attn_flash", case,
                       lambda: attn_flash(qb, kb, vb, **kw)))
        row["bound_ms"], row["bound_by"] = bound_ms(
            2.0 * hd * pairs, nbytes, bf16_flops=2.0 * hd * pairs)
        summary["attn_flash"].append(row)
        print("KERNEL attn_flash", json.dumps(row), flush=True)

    p_tab = -(-(CONT_PROMPTS[1] + CONT_HORIZONS[1]) // CONT_PAGE)
    smol, phi3 = (15, 5, 64), (32, 32, 96)
    for case, (b, s, idle, p, np_, full), (hp, hkv, hd), path in (
            ("decode step", (CONT_SLOTS, 1, 1, p_tab, CONT_PAGES, False),
             smol, "smollm"),
            ("prefill chunk", (1, CONT_PAGE, 0, p_tab, CONT_PAGES, False),
             smol, "smollm"),
            ("decode step, 128-page tables",
             (CONT_SLOTS, 1, 0, 128, CONT_SLOTS * 128 + 16, True), smol,
             None),
            ("phi3-mini decode step hd 96",
             (CONT_SLOTS, 1, 1, p_tab, CONT_PAGES, False), phi3, "families"),
            ("phi3-mini prefill chunk hd 96",
             (1, CONT_PAGE, 0, p_tab, CONT_PAGES, False), phi3, "families"),
            ("phi3-mini decode step hd 96, 128-page tables",
             (CONT_SLOTS, 1, 0, 128, CONT_SLOTS * 128 + 16, True), phi3,
             None)):
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
        row = dict(case=case, main_path=path == "smollm", path=path,
                   slots=b, rows=s,
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


@contextlib.contextmanager
def plain_norm():
    """The norm's plain version in the norm kernel's place, so that a
    forward's statistics sum in the oracle's order and every other kernel
    of it can be held to the oracle bit for bit."""
    from repro_torch.kernels import norm_act as N

    kernel = N.norm_act
    N.norm_act = N.norm_act_plain
    try:
        yield
    finally:
        N.norm_act = kernel


def _held_to_plain(tag: str, got: np.ndarray, ref: np.ndarray,
                   forward) -> dict:
    """``got``, through the norm kernel, within the tolerance of the
    oracle's ``ref``; ``forward()``, the same forward under
    :func:`plain_norm`, equal to ``ref`` bit for bit."""
    held = _check_logits(tag, got, ref)
    with plain_norm():
        exact = forward()
    held["plain_norm"] = _check_logits(f"{tag}, plain norm", exact, ref,
                                       exact=True)
    return held


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
                fused_qgemm=1 * svhn_dispatches + 2,
                norm_act=7 * svhn_dispatches + 7)
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
        vs_plain = _held_to_plain(
            f"svhn {tag} vs plain", got, ref, lambda dep=dep: np.stack(
                [r.value for r in dep.engine.serve(images)]))
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
        vs_plain=_held_to_plain(
            "alexnet vs plain", got, ref,
            lambda: alex.forward(x_alex).cpu().numpy()),
        alone_vs_batched=_check_logits("alexnet alone vs batched", alone,
                                       got),
        fc5_vs_plain=_held_to_plain(
            "alexnet fc5 vs plain", feats.cpu().numpy(),
            feats_ref.cpu().numpy(),
            lambda: P.execute_cnn_layers(head, alex.params[:6], x_alex,
                                         W1A8).cpu().numpy()),
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
                int8_matmul=12 * disp["w1a8 int8"],
                norm_act=7 * sum(disp.values()) + 7)
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
            vs_plain=_held_to_plain(
                f"svhn {tag} vs plain", got, ref, lambda dep=dep: np.stack(
                    [r.value for r in dep.engine.serve(images)])),
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
        vs_plain=_held_to_plain(
            "alexnet faithful vs plain", got,
            alex.forward(x_alex, reference=True).cpu().numpy(),
            lambda: alex.forward(x_alex).cpu().numpy()),
        vs_default_engines=_check_logits(
            "alexnet faithful vs default engines", got,
            alex_default.forward(x_alex).cpu().numpy(), exact=True),
        fc5_vs_plain=_held_to_plain(
            "alexnet faithful fc5 vs plain", feats.cpu().numpy(),
            feats_ref.cpu().numpy(),
            lambda: P.execute_cnn_layers(head, alex.params[:6], x_alex,
                                         alex.plan.quant).cpu().numpy()),
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


def _host_ms(fn, reps: int = 5) -> float:
    """Median host wall ms of ``reps`` synchronized calls of ``fn``."""
    return float(np.median([_sync_ms(fn)[1] for _ in range(reps)]))


def spec_phase(card: str) -> dict:
    """The legacy served entry point ``cnn_forward(mode="serve")`` on the
    card, and the paper's spec walk beside the ``cuda`` plans (see 4c)."""
    import dataclasses

    from repro_torch import api
    from repro_torch.core import plan as P
    from repro_torch.core.prequant import serve_weight_bytes
    from repro_torch.core.quant import W1A1, W1A4, W1A8
    from repro_torch.kernels import _lib
    from repro_torch.models.cnn import (alexnet_spec, cnn_forward, init_cnn,
                                        svhn_cnn_spec)
    from repro_torch.pim.energy import TABLE2_AREA_MM2
    from repro_torch.pim.mapper import (compare_designs, model_work,
                                        works_from_layers)

    dev = torch.device("cuda")
    rs = np.random.RandomState(SPEC_SEED)
    svhn, alex = svhn_cnn_spec(), alexnet_spec()
    svhn_p = init_cnn(torch.Generator(device=dev).manual_seed(0), svhn)
    alex_p = init_cnn(torch.Generator(device=dev).manual_seed(1), alex)

    def image(hw):
        return torch.from_numpy(rs.uniform(0, 1, (8, hw, hw, 3)).astype(
            np.float32)).to(dev)

    x40, x224 = image(40), image(224)
    faithful = dataclasses.replace(W1A1, engine="faithful")
    cases = (("svhn w1a4", svhn, W1A4, svhn_p, x40, SPEC_LAUNCHES["svhn"]),
             ("svhn w1a8", svhn, W1A8, svhn_p, x40, SPEC_LAUNCHES["svhn"]),
             ("alexnet w1a8", alex, W1A8, alex_p, x224,
              SPEC_LAUNCHES["alexnet"]),
             ("svhn w1a1 faithful", svhn, faithful, svhn_p, x40,
              SPEC_LAUNCHES["faithful"]))
    report = {"cases": {}, "card": card}
    for tag, spec, q, params, x, want in cases:
        hw = x.shape[1]
        compiled = api.build(spec, q, params=params, img_hw=hw).compile(
            target="cuda", batch_hints=(8,))
        cnn_forward(params, x, spec, q, "serve")          # warm-up
        torch.cuda.synchronize()
        outs, launches = [], []
        for p in (params, params, compiled.params):
            _lib.reset_launches()
            outs.append(cnn_forward(p, x, spec, q, "serve"))
            torch.cuda.synchronize()
            launches.append({k: v for k, v in _lib.LAUNCHES.items() if v})
        for i, got in enumerate(launches):
            check(got == want, f"spec {tag}: call {i} launched {got}, "
                               f"expected {want}")
        check(all(o.device.type == "cuda" for o in outs),
              f"spec {tag}: logits not on the card")
        layers = P.layers_for_batch(compiled.plan, 8)
        plain = P.execute_cnn_layers(layers, compiled.params, x, q,
                                     reference=True)
        row = dict(launches_per_call=launches[0],
                   vs_compiled=_check_logits(
                       f"spec {tag} vs compiled", outs[0].cpu().numpy(),
                       compiled.forward(x).cpu().numpy(), exact=True),
                   vs_plain=_held_to_plain(
                       f"spec {tag} vs plain", outs[0].cpu().numpy(),
                       plain.cpu().numpy(),
                       lambda: cnn_forward(params, x, spec, q, "serve")
                       .cpu().numpy()))
        for i, o in enumerate(outs[1:], 1):
            check(torch.equal(o, outs[0]), f"spec {tag}: call {i} differs "
                                           f"from call 0")
        if spec is alex:
            # past fc5 the logits do not depend on the image (per-sample
            # norm on 1x1 maps): fc5's own output is held too
            legacy = P.cnn_serve_layers(spec, q, batch=8, img_hw=(hw, hw))
            row["fc5_vs_plain"] = _held_to_plain(
                f"spec {tag} fc5 vs plain",
                P.execute_cnn_layers(legacy[:6], params[:6], x, q)
                .cpu().numpy(),
                P.execute_cnn_layers(layers[:6], compiled.params[:6], x, q,
                                     reference=True).cpu().numpy(),
                lambda: P.execute_cnn_layers(legacy[:6], params[:6], x, q)
                .cpu().numpy())
        row.update(
            host_ms_float_params=_host_ms(
                lambda: cnn_forward(params, x, spec, q, "serve")),
            host_ms_prequantized_params=_host_ms(
                lambda: cnn_forward(compiled.params, x, spec, q, "serve")),
            host_ms_compiled_forward=_host_ms(lambda: compiled.forward(x)))
        works = works_from_layers(compiled.plan.layers)
        walk = model_work(spec, hw, q.a_bits, q.w_bits)
        check(works == walk, f"spec {tag}: model_work != works_from_layers "
                             f"of the cuda plan")
        row["model_work_equals_plan_works"] = True
        row["macs"] = sum(w.macs for w in works)
        if tag == "svhn w1a4":
            report["serve_weight_bytes"] = dict(
                svhn_w1a4_plan_params=serve_weight_bytes(compiled.params),
                svhn_float_params=serve_weight_bytes(params))
        report["cases"][tag] = row
        del compiled, plain, outs
    report["compare_designs"] = dict(
        model="alexnet", img=224, m_bits=1, n_bits=1,
        note="the paper's PIM model (pim.energy), not a measurement of "
             "the card",
        designs=compare_designs(alex, 224, 1, 1, TABLE2_AREA_MM2))
    print("SPEC", json.dumps(report), flush=True)
    return report


def _hold_tokens(tag: str, got: np.ndarray, ref: np.ndarray,
                 margins: np.ndarray, tol: float | None = LM_MARGIN_TOL
                 ) -> dict:
    """Greedy tokens of one request (or rows of a batch) against the
    oracle's: equal, or first different at a position whose oracle top-2
    logit margin is under ``tol`` (logit units).  Later positions follow
    another prefix and are not compared.  ``tol=None`` reports each first
    difference with its margin and fails on none."""
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
        check(tol is None or m < tol, f"{tag}: row {r} differs at "
              f"position {t} where the oracle's top-2 margin is {m} >= "
              f"{tol}")
        div.append(dict(row=r, position=t, margin=m))
    return dict(positions=int(got.size), divergences=div)


def _cont_payloads(rs: np.random.RandomState, vocab: int) -> list:
    """CONT_REQUESTS (prompt, horizon) requests of the continuous mix."""
    return [(rs.randint(0, vocab, rs.randint(
        CONT_PROMPTS[0], CONT_PROMPTS[1] + 1)).astype(np.int32),
        int(rs.randint(CONT_HORIZONS[0], CONT_HORIZONS[1] + 1)))
        for _ in range(CONT_REQUESTS)]


def _cont_engine(params, cfg, **kw):
    """The continuous engine of the LM paths: CONT_SLOTS slots, pages of
    CONT_PAGE, CONT_PAGES pages, room for the longest request."""
    from repro_torch.launch.engine import ContinuousLMEngine

    return ContinuousLMEngine(params, cfg, num_slots=CONT_SLOTS,
                              page_size=CONT_PAGE, num_pages=CONT_PAGES,
                              max_seq=CONT_PROMPTS[1] + CONT_HORIZONS[1],
                              new_tokens=LM_NEW, **kw)


def lm_main_path(card: str) -> dict:
    """Full-width SmolLM-360M W1A8 through both LM entry points."""
    import dataclasses

    from repro_torch.configs import SINGLE, get_config
    from repro_torch.core.quant import W1A8
    from repro_torch.kernels import _lib
    from repro_torch.launch.engine import LMRunner, ServeEngine
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
    payloads = _cont_payloads(rs, cfg.vocab)
    cont_engine = functools.partial(_cont_engine, params, cfg)
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
    prefill_logits = _logit_gap(last_k.float(), last_p.float())
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
    # one dispatch on the primary plan, three on the fallback: 7 norms each
    want_l = dict(conv_implicit=5, fused_qgemm=1, quantize_pack=18,
                  bitgemm_packed=18, norm_act=7 * 4)
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


class _Proofs:
    """Stands in for the prover's ``assert_plan_verified``, which every
    compile path of the port calls (``verify=True``, their default), and
    records each proof: the plan, its violations and ``verify_plan``'s
    milliseconds."""

    def __init__(self):
        from repro_torch.analysis import prover

        self.prover, self.rows = prover, []

    def install(self) -> "_Proofs":
        self.prover.assert_plan_verified = self
        return self

    def __call__(self, plan, target=None) -> None:
        t0 = time.perf_counter()
        violations = self.prover.verify_plan(plan, target)
        self.rows.append(dict(
            model=plan.model, kind=plan.kind, quant=plan.quant.tag(),
            rows=len(plan.layers), violations=len(violations),
            verify_ms=1e3 * (time.perf_counter() - t0)))
        if violations:
            raise self.prover.PlanVerificationError(violations)


PROOFS: _Proofs | None = None


def _analysis_cli(*args, timeout=300) -> subprocess.Popen:
    """``python -m repro_torch.analysis ARGS`` from the repository root in
    a CPU-only interpreter, started (read with ``.communicate()``)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _family_plans() -> list:
    """Each family's LM plan at full width, one pattern period deep,
    compiled (and so proven) on the card: its rows and proof ms."""
    import dataclasses
    import gc

    from repro_torch import api
    from repro_torch.configs import SINGLE, get_config
    from repro_torch.core.quant import W1A8
    from repro_torch.models import transformer as T

    out = []
    archs = [(a, prompt) for a, _, prompt, _, _ in FAMILIES] + [
        ("hubert-xlarge", MOD_FRAMES), ("internvl2-26b", 2048)]
    for arch, prompt in archs:
        cfg = dataclasses.replace(get_config(arch), quant=W1A8)
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
        params = T.init_lm(torch.Generator(device="cuda").manual_seed(
            FAM_SEED), cfg, SINGLE)
        n = len(PROOFS.rows)
        plan = api.build(cfg, params=params).compile(
            target="cuda", prompt_len=prompt, batch_hints=(FAM_BATCH,)).plan
        check(len(PROOFS.rows) == n + 1, f"{arch}: the compile proved "
                                         f"{len(PROOFS.rows) - n} plans")
        out.append(dict(arch=arch, n_layers=cfg.n_layers, prompt_len=prompt,
                        rows=len(plan.layers), dense=len(plan.dense_table),
                        attn_table=sorted(set(plan.attn_table.values())),
                        verify_ms=PROOFS.rows[-1]["verify_ms"]))
        del params, plan
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _bound_plans() -> dict:
    """The prover's boundaries as one-row plans: kernel -> (boundary, the
    shape just inside, its plan, the shape just outside, its plan)."""
    from repro_torch.core.plan import LayerPlan, ModelPlan
    from repro_torch.core.quant import W1A8
    from repro_torch.kernels import conv_implicit as ci
    from repro_torch.kernels import ops

    def row(op, k, engine, a_bits, w_bits, **geom):
        base = dict(index=0, name="bound", op=op, role="mid", fp=False,
                    kh=1, kw=1, stride=1, padding="SAME", cin=k, cout=64,
                    in_h=1, in_w=1, out_h=1, out_w=1, k=k, a_bits=a_bits,
                    w_bits=w_bits, engine=engine, engine_source="override",
                    engines=((1, engine),), cost=(1.0, 1.0, 1.0))
        return LayerPlan(**{**base, **geom})

    def cnn(r):
        return ModelPlan(kind="cnn", model="bound", backend="cuda",
                         quant=W1A8, batch_hints=(1,), layers=(r,))

    def attn(shape, engine, batch):
        r = row("attn", shape.head_dim, engine, 8, 8, cin=0, cout=0, kh=0,
                kw=0, padding="", in_h=0, in_w=0, out_h=0, out_w=0,
                attn_engine=engine, engines=((batch, engine),))
        return ModelPlan(kind="lm", model="bound", backend="cuda",
                         quant=W1A8, batch_hints=(batch,), layers=(r,),
                         attn_table={ops.attn_plan_key(shape, "cuda"):
                                     engine})

    def gemm(k, engine, bits):     # (16, K) x (K, 64): a 4x4 1x1 conv
        return cnn(row("conv", k, engine, bits, bits, in_h=4, in_w=4,
                       out_h=4, out_w=4))

    c = ANALYSIS_CONV
    w_in = next(w for w in range(16, 4096) if ci.smem_layout(
        c["h"], w + 1, c["cin"], 3, 3, 1, "SAME", 1, c["cout"]).smem_bytes
        > ci.SMEM_LIMIT)

    def conv(w):
        return cnn(row("conv", 9 * c["cin"], "implicit", 8, 1, kh=3, kw=3,
                       cin=c["cin"], cout=c["cout"], in_h=c["h"], in_w=w,
                       out_h=c["h"], out_w=w))

    fl, pg = ANALYSIS_FLASH, ANALYSIS_PAGED

    def flash(hd):
        return attn(ops.AttnShape(seq_q=fl["s"], seq_kv=fl["s"],
                                  heads=fl["h"], head_dim=hd,
                                  quantized=True), "flash", fl["b"])

    def paged(hd):
        return attn(ops.AttnShape(seq_q=1, seq_kv=pg["p"] * pg["ps"],
                                  heads=pg["h"], head_dim=hd, quantized=True,
                                  page_size=pg["ps"]), "paged", pg["b"])

    return {
        "fused_qgemm": ("W8A8 int32 accumulator: 255*255*K < 2^31",
                        33025, gemm(33025, "fused", 8), 33026,
                        gemm(33026, "fused", 8)),
        "int8_matmul": ("s8 x s8 partial sums: 128*128*K < 2^31",
                        131071, gemm(131071, "int8", 1), 131072,
                        gemm(131072, "int8", 1)),
        "conv_implicit": (f"shared memory <= {ci.SMEM_LIMIT} B a block",
                          w_in, conv(w_in), w_in + 1, conv(w_in + 1)),
        "attn_flash": ("head_dim in KERNEL_HEAD_DIMS", 128, flash(128), 112,
                       flash(112)),
        "attn_paged": ("paged_smem_bytes <= SMEM_LIMIT", 128, paged(128),
                       256, paged(256)),
    }


def _bound_cases(dev) -> dict:
    """kernel -> ``make(value)`` -> (the kernel's call, its plain
    version's call on the same inputs, max|v| for the attention kernels'
    tolerance or None): the shapes of ``_bound_plans``, each with a
    worst-case operand row, so the accumulator reaches its bound."""
    from repro_torch.kernels import bitgemm_mxu, conv_implicit, fused_qgemm
    from repro_torch.kernels.attn_flash import attn_flash, attn_paged

    gen = torch.Generator(device=dev).manual_seed(23)
    rs = np.random.RandomState(23)
    c, fl, pg = ANALYSIS_CONV, ANALYSIS_FLASH, ANALYSIS_PAGED

    def u8(*shape, hi=256):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.uint8)

    def pair(kernel, plain, *args, vmax=None, **kw):
        return (lambda: kernel(*args, **kw), lambda: plain(*args, **kw),
                vmax)

    def fused(k):
        a, w = u8(16, k), u8(k, 64)
        a[0], w[:, 0] = 255, 255            # out[0, 0]: 255 * 255 * K
        return pair(fused_qgemm.fused_qgemm, fused_qgemm.fused_qgemm_plain,
                    a, w, 0.0079, 127.5, a_bits=8, w_bits=8,
                    a_is_levels=True)

    def int8(k):
        a = torch.randint(-128, 128, (16, k), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (k, 64), generator=gen, device=dev,
                          dtype=torch.int8)
        a[0], b[:, 0] = -128, -128          # out[0, 0]: 128 * 128 * K
        return pair(bitgemm_mxu.int8_matmul, bitgemm_mxu.int8_matmul_plain,
                    a, b)

    def conv(w):
        x, wl = u8(1, c["h"], w, c["cin"]), u8(9 * c["cin"], c["cout"], hi=2)
        return pair(conv_implicit.conv_implicit,
                    conv_implicit.conv_implicit_plain, x, wl, 0.0421, 0.5,
                    kh=3, kw=3, stride=1, padding="SAME", a_bits=8, w_bits=1)

    def flash(hd):
        q, k, v = (torch.randn((fl["b"], fl["s"], fl["h"], hd), generator=gen,
                               device=dev) for _ in range(3))
        return (lambda: attn_flash(q, k, v, causal=True),
                lambda: attn_flash(q, k, v, causal=True, reference=True),
                float(v.abs().max()))

    def paged(hd):
        q, pk, pv, ppos, table, q_pos = _paged_case(
            dev, gen, rs, b=pg["b"], s=1, hp=pg["h"], hkv=pg["h"], hd=hd,
            ps=pg["ps"], np_=pg["np_"], p=pg["p"])

        def call(reference):
            out = attn_paged(q, pk, pv, ppos, table, q_pos, causal=True,
                             quantized=True, n_q_heads=pg["h"],
                             reference=reference)
            return out[q_pos >= 0]

        return (lambda: call(False), lambda: call(True),
                float(pv.abs().max()))

    return {"fused_qgemm": fused, "int8_matmul": int8,
            "conv_implicit": conv, "attn_flash": flash, "attn_paged": paged}


def _hold_bounds(dev) -> list:
    """Each boundary: the prover's verdict on the shape just inside and
    just outside, held against the kernel on the card (module docstring,
    5c2)."""
    from repro_torch.analysis.prover import verify_plan
    from repro_torch.kernels import _lib

    cases, rows = _bound_cases(dev), []
    for name, (bound, v_in, p_in, v_out, p_out) in _bound_plans().items():
        inside = verify_plan(p_in)
        check(inside == [], f"{name} at {v_in}: the prover refuses the "
                            f"shape inside its bound: {inside}")
        kernel, plain, vmax = cases[name](v_in)
        before = _lib.LAUNCHES[name]
        got = kernel()
        launched = _lib.LAUNCHES[name] - before
        ref = plain()
        torch.cuda.synchronize()
        check(launched == 1, f"{name} at {v_in}: {launched} launches")
        if vmax is None:
            held = dict(bit_identical=bool(torch.equal(got, ref)))
            check(held["bit_identical"], f"{name} at {v_in}: the kernel "
                                         "differs from its plain version")
        else:
            err, tol = float((got - ref).abs().max()), ATTN_TOL_F32 * vmax
            held = dict(max_abs_err=err, tol=tol)
            check(err <= tol, f"{name} at {v_in}: max abs {err} > {tol}")
        outside = sorted({v.rule for v in verify_plan(p_out)})
        check(outside != [], f"{name} at {v_out}: the prover proves the "
                             "shape outside the kernel's bound")
        kernel, _, _ = cases[name](v_out)
        before = _lib.LAUNCHES[name]
        try:
            kernel()
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None, f"{name} at {v_out}: the wrapper "
                                  "accepted a shape the prover refuses")
        check(_lib.LAUNCHES[name] == before,
              f"{name} at {v_out}: launched past the bound")
        rows.append(dict(kernel=name, bound=bound,
                         inside=dict(at=v_in, proven=True, launches=launched,
                                     **held),
                         outside=dict(at=v_out, rules=outside,
                                      wrapper_raised=raised, launches=0)))
    return rows


def analysis_phase(card: str) -> dict:
    """Static verification on the card (module docstring, 5c2): the
    ``ANALYSIS`` line."""
    import dataclasses
    import shutil

    from repro_torch import api
    from repro_torch.analysis.lint import launcher_signatures
    from repro_torch.configs import SINGLE, get_config
    from repro_torch.core.quant import W1A8
    from repro_torch.kernels import _lib, ops
    from repro_torch.models import transformer as T
    from repro_torch.models.cnn import alexnet_spec, init_cnn, svhn_cnn_spec

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    work = os.path.join(ROOT, "build", "analysis_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    lint = _analysis_cli("lint", "src/repro_torch", "chip_smoke.py")
    ops.clear_plan_state()
    earlier = list(PROOFS.rows)
    smol = [r for r in earlier if r["model"] == "smollm-360m"]
    check(smol, "no SmolLM-360M plan was proven before this phase")
    fam = _family_plans()
    largest = max(fam, key=lambda r: r["rows"])

    # saved artifacts through the CLI
    t0 = time.perf_counter()
    svhn = api.build(svhn_cnn_spec(), W1A8, params=init_cnn(
        torch.Generator(device=dev).manual_seed(0), svhn_cnn_spec()),
        img_hw=40, name="svhn").compile(target="cuda", batch_hints=(1, 8))
    alex_params = init_cnn(torch.Generator(device=dev).manual_seed(1),
                           alexnet_spec())
    alex_model = api.build(alexnet_spec(), W1A8, params=alex_params,
                           img_hw=224, name="alexnet")
    alex = alex_model.compile(target="cuda", batch_hints=(1, 8))
    cfg = dataclasses.replace(get_config("smollm-360m"), quant=W1A8)
    lm = api.build(cfg, params=T.init_lm(
        torch.Generator(device=dev).manual_seed(2), cfg, SINGLE)).compile(
        target="cuda", prompt_len=LM_PROMPT, batch_hints=(LM_BATCH,),
        page_size=CONT_PAGE, kv_pages=PLAN_KV_PAGES)
    paths = [c.save(os.path.join(work, name)) for name, c in (
        ("svhn_w1a8", svhn), ("alexnet_w1a8", alex), ("smollm_w1a8", lm))]
    del svhn, alex, lm
    compiled_s = time.perf_counter() - t0
    proven = PROOFS.rows[len(earlier) + len(fam):]
    t0 = time.perf_counter()
    good = _analysis_cli("check-plan", *paths)
    edited = os.path.join(work, "alexnet_w1a8_edited.json")
    model, idx, was, to = ANALYSIS_EDIT
    with open(paths[1]) as f:
        meta = json.load(f)
    row = meta["layers"][idx]
    check(row["engine"] == was and row["kh"] == 1,
          f"{model} layer {idx}: {row['engine']} {row['kh']}x{row['kw']}")
    row["engine"] = to
    row["engines"] = [[b, to] for b, _ in row["engines"]]
    with open(edited, "w") as f:       # its levels stay the original's
        json.dump(meta, f)
    bad = _analysis_cli("check-plan", edited)
    # the facade's reload of the edited artifact: refused before a launch
    from repro_torch.analysis.prover import PlanVerificationError

    n_clean = len(PROOFS.rows)
    before = dict(_lib.LAUNCHES)
    try:
        alex_model.compile(target="cuda", batch_hints=(1, 8), cache=edited)
        reload_raised = None
    except PlanVerificationError as e:
        reload_raised = [v.rule for v in e.violations]
    check(reload_raised and set(reload_raised) == {"PV103"},
          f"compile(cache=<edited>) raised {reload_raised}")
    check(_lib.LAUNCHES == before, "compile(cache=<edited>) launched")
    del alex_params, alex_model
    torch.cuda.empty_cache()
    good_out, _ = good.communicate(timeout=300)
    bad_out, _ = bad.communicate(timeout=300)
    cli_s = time.perf_counter() - t0
    check(good.returncode == 0, f"check-plan on the saved plans exited "
                                f"{good.returncode}:\n{good_out}")
    check(bad.returncode == 1 and "PV103" in bad_out,
          f"check-plan on the edited plan exited {bad.returncode}:\n"
          f"{bad_out}")

    t0 = time.perf_counter()
    bounds = _hold_bounds(dev)
    bounds_s = time.perf_counter() - t0

    sites = launcher_signatures([os.path.join(ROOT, "src", "repro_torch")],
                                root=ROOT)
    lint_out, _ = lint.communicate(timeout=300)
    check(lint.returncode == 0, f"repro-lint exited {lint.returncode}:\n"
                                f"{lint_out}")
    check(len(sites) == 14, f"RL004 proved {len(sites)} launchers, not 14")
    clean = PROOFS.rows[:n_clean]
    total = sum(r["violations"] for r in clean)
    check(total == 0, f"{total} violations among the compiled plans")
    line = dict(
        card=card,
        plans=dict(proven=len(clean), violations=total,
                   earlier_phases=len(earlier),
                   families=len(fam), artifacts=len(proven),
                   verify_ms_smollm_360m=[r["verify_ms"] for r in smol],
                   smollm_rows=smol[0]["rows"],
                   largest_family=dict(arch=largest["arch"],
                                       rows=largest["rows"],
                                       verify_ms=largest["verify_ms"]),
                   verify_ms_max=max(r["verify_ms"] for r in clean),
                   by_model=sorted({(r["model"], r["quant"], r["rows"])
                                    for r in earlier})),
        families=fam,
        check_plan=dict(saved=[os.path.basename(p) for p in paths],
                        rc=good.returncode, output=good_out.strip(),
                        edited=dict(model=model, layer=idx, engine=[was, to],
                                    rc=bad.returncode,
                                    output=bad_out.strip().splitlines()[-1],
                                    compile_cache_raised=reload_raised,
                                    launches_unchanged=True)),
        bounds=bounds,
        lint=dict(rc=lint.returncode, output=lint_out.strip(),
                  rl004_sites=len(sites)),
        seconds=dict(compile_and_save=compiled_s, cli=cli_s,
                     bounds=bounds_s,
                     phase=time.perf_counter() - t_phase))
    print("ANALYSIS", json.dumps(line), flush=True)
    return line


def _tree_gb(tree) -> float:
    if isinstance(tree, dict):
        return sum(_tree_gb(v) for v in tree.values())
    return tree.numel() * tree.element_size() / 1e9


def _served_model(arch: str, cut) -> tuple:
    """``arch``'s config at W1A8 (``cut`` layers kept, or all) and its
    params drawn on the card from FAM_SEED and prequantized.  Returns
    ``(cfg, params, report)``: params GB drawn and served, init and
    prequantize seconds and, for a cut, why it is ``reduced``."""
    import dataclasses

    from repro_torch.configs import SINGLE, get_config
    from repro_torch.core.quant import W1A8
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import prequantize_params

    cfg = dataclasses.replace(get_config(arch), quant=W1A8)
    full = cfg.n_layers
    if cut:
        cfg = dataclasses.replace(cfg, n_layers=cut)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(FAM_SEED),
                       cfg, SINGLE)
    blocks_gb = _tree_gb(params["blocks"])
    out = dict(params_gb=_tree_gb(params))
    params = prequantize_params(params, cfg)
    torch.cuda.synchronize()
    out["init_and_prequantize_s"] = time.perf_counter() - t0
    out["served_params_gb"] = _tree_gb(params)
    if cut:
        full_gb = out["params_gb"] + blocks_gb * (full / cut - 1)
        out["reduced"] = {"n_layers": [full, cut], "why": (
            f"float32 params at full depth, {full_gb:.1f} GB, do not fit "
            f"beside the working set on the 80 GB card")}
    return cfg, params, out


def _family_run(arch: str, cut, prompt_len: int, new: int,
                continuous: bool) -> dict:
    """One architecture of the families phase (see ``families_phase``)."""
    import gc

    from repro_torch.configs import SINGLE
    from repro_torch.kernels import _lib
    from repro_torch.launch.engine import (ContinuousLMEngine, LMRunner,
                                           ServeEngine)
    from repro_torch.launch.serve import make_prefill, serve_once
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import resolve_attn_engine

    dev = torch.device("cuda")
    cfg, params, drawn = _served_model(arch, cut)
    out = dict(arch=arch, layers=cfg.n_layers, width=cfg.d_model,
               batch=FAM_BATCH, prompt_len=prompt_len, new_tokens=new,
               **drawn)
    attn_kinds = [k for k in dict.fromkeys(cfg.blocks_pattern)
                  if k in T.ATTN_KINDS]
    out["attention_engine"] = {k: resolve_attn_engine(
        cfg, seq_q=prompt_len, seq_kv=prompt_len,
        heads=SINGLE.padded_heads(cfg.n_heads), causal=True,
        window=cfg.window if k == "attn_local" else None, qmode="serve")
        for k in attn_kinds}
    n_attn = sum(cfg.n_blocks_of(k) for k in attn_kinds)
    rs = np.random.RandomState(FAM_SEED)
    prompts = [rs.randint(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(FAM_BATCH)]
    toks = torch.from_numpy(np.stack(prompts)).to(dev)
    bucket = ServeEngine(LMRunner(params, cfg, new_tokens=new),
                         max_batch=FAM_BATCH)
    bucket.serve([prompts[0][:64]])                  # warm-up, not counted
    torch.cuda.synchronize()
    # ---- this architecture's bucket path, counted
    d0 = bucket.stats["dispatches"]
    _lib.reset_launches()
    t0 = time.perf_counter()
    res = bucket.serve(prompts)
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    # ----
    disp = bucket.stats["dispatches"] - d0
    want = {k: 0 for k in launches}
    want["attn_flash"] = disp * sum(
        cfg.n_blocks_of(k) for k, e in out["attention_engine"].items()
        if e == "flash")
    check(disp == 1, f"{arch}: {disp} bucket dispatches")
    check(launches == want, f"{arch}: launches {launches} != {want}")
    b_tok = np.stack([r.value for r in res])
    check(b_tok.shape == (FAM_BATCH, new)
          and bool(np.all((b_tok >= 0) & (b_tok < cfg.vocab))),
          f"{arch}: bucket tokens {b_tok.shape} or outside the vocab")
    del bucket

    def last_logits(reference: bool) -> torch.Tensor:
        logits, _ = make_prefill(params, cfg, SINGLE, "serve",
                                 reference)(toks)
        last = logits[:, -1, :cfg.vocab].float()
        check(bool(torch.isfinite(last).all()), f"{arch}: prefill logits")
        return last

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = last_logits(False)
    prefill_s = time.perf_counter() - t0
    plain_last = last_logits(True)
    gap = _logit_gap(last, plain_last)
    del last
    out.update(
        launches={k: v for k, v in launches.items() if v},
        bucket_wall_s=wall, tokens_per_s=FAM_BATCH * new / wall,
        prefill_ms=1e3 * prefill_s,
        prefill_tokens_per_s=FAM_BATCH * prompt_len / prefill_s,
        prefill_last_logits_vs_plain=gap)

    def tokens(**kw):
        return serve_once(params, cfg, SINGLE, toks, new, "serve",
                          **kw)[0].cpu().numpy()

    margins = []
    ref_tok = tokens(reference=True, margins=margins)
    margins = torch.stack(margins, dim=1).cpu().numpy()
    if n_attn:
        # each side run again: every difference sits where it sat
        check(np.array_equal(tokens(reference=True), ref_tok),
              f"{arch}: a second plain run's tokens differ from the first")
        with _InContext() as ctx:
            ctx_tok = tokens()
        check(np.array_equal(ctx_tok, b_tok),
              f"{arch}: the in-context run's tokens are not the bucket's")
        # the witness: the plain version at another float order
        with _plain_reordered():
            re_tok = tokens(reference=True)
            re_gap = _logit_gap(last_logits(True), plain_last)
        check(gap["max_abs_diff"] <= FAM_GAP_FACTOR * re_gap["max_abs_diff"],
              f"{arch}: the kernels move the prefill's last logits by "
              f"{gap['max_abs_diff']}, over {FAM_GAP_FACTOR} x the "
              f"reordered plain version's {re_gap['max_abs_diff']}")
        if "rec" in cfg.blocks_pattern:
            out["rglru_assoc"] = _assoc_prefill(params, cfg, toks,
                                                plain_last, re_gap,
                                                n_attn)
        out.update(
            kernels_in_context=ctx.report(f"{arch} bucket"),
            oracle=("serve_once on the same padded batch, attention "
                    "kernels' plain versions; each side run twice, bit for "
                    "bit"),
            plain_reordered_vs_plain=dict(
                prefill_last_logits=re_gap,
                tokens=_hold_tokens(f"{arch} reordered plain vs plain",
                                    re_tok, ref_tok, margins, None)))
    else:
        check(np.array_equal(b_tok, ref_tok), f"{arch}: the bucket's "
              f"tokens are not serve_once's on the same batch")
        out["oracle"] = ("serve_once on the same padded batch (no kernel "
                         "on this path), bit for bit")
    del plain_last
    out["vs_plain"] = _hold_tokens(f"{arch} bucket vs plain", b_tok, ref_tok,
                                   margins, None)
    if continuous:
        out["continuous"] = _family_continuous(arch, params, cfg)
        out["profile_decode_step"] = bucket_step_profile(
            params, cfg, T.unstack_layers(params, cfg), FAM_BATCH,
            prompt_len, new)
    elif set(cfg.blocks_pattern) != {"attn"}:
        try:
            ContinuousLMEngine(params, cfg, num_slots=2, page_size=CONT_PAGE,
                               num_pages=8)
        except ValueError as e:
            out["continuous_refused"] = str(e)
        check("continuous_refused" in out,
              f"{arch}: ContinuousLMEngine took a non-'attn' pattern")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _assoc_prefill(params, cfg, toks, plain_last, re_gap, n_attn) -> dict:
    """recurrentgemma's prefill with ``rglru_assoc=True`` on the same
    params: its first recurrent block's scan (the model's own inputs,
    captured from the sequential prefill's first call) in both forms,
    float32 h within RG_ASSOC_H_TOL x max|h|; the prefill's last logits
    under the families' witness gate (FAM_GAP_FACTOR x the reordered plain
    version's gap to the sequential plain run); its launches; both
    prefill times (each the second of two runs)."""
    import dataclasses

    from repro_torch.configs import SINGLE
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import make_prefill
    from repro_torch.models import rglru

    seen = []
    orig = rglru._rglru_scan
    rglru._rglru_scan = lambda xg, a, h0: (
        seen.append((xg, a, h0)) if not seen else None, orig(xg, a, h0))[1]
    try:
        make_prefill(params, cfg, SINGLE, "serve", False)(toks)
    finally:
        rglru._rglru_scan = orig
    xg, a, h0 = seen[0]
    h_seq, _ = rglru._rglru_scan(xg, a, h0)
    h_par, _ = rglru._rglru_assoc(xg, a, h0)
    h_gap = float((h_par - h_seq).abs().max()) / float(h_seq.abs().max())
    check(h_gap <= RG_ASSOC_H_TOL, f"{cfg.name}: the parallel RG-LRU scan "
          f"is {h_gap} x max|h| from the sequential one")
    del seen, xg, a, h0, h_seq, h_par
    out = dict(block_h_gap_over_max_h=h_gap, h_tol=RG_ASSOC_H_TOL,
               scan_shape=list(toks.shape) + [cfg.lru_width])
    last = {}
    for name, c in (("sequential", cfg),
                    ("assoc", dataclasses.replace(cfg, rglru_assoc=True))):
        step = make_prefill(params, c, SINGLE, "serve", False)
        for _ in range(2):
            _lib.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = step(toks)
            last[name] = logits[:, -1, :cfg.vocab].float()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            del logits
        out[f"{name}_prefill_ms"] = ms
        out[f"{name}_launches"] = {k: v for k, v in _lib.LAUNCHES.items()
                                   if v}
        check(_lib.LAUNCHES["attn_flash"] == n_attn,
              f"{cfg.name} {name}: {_lib.LAUNCHES['attn_flash']} attn_flash "
              f"launches, not {n_attn}")
    gap = _logit_gap(last["assoc"], plain_last)
    check(bool(torch.isfinite(last["assoc"]).all()),
          f"{cfg.name} assoc: logits")
    check(gap["max_abs_diff"] <= FAM_GAP_FACTOR * re_gap["max_abs_diff"],
          f"{cfg.name} assoc: the prefill's last logits move by "
          f"{gap['max_abs_diff']}, over {FAM_GAP_FACTOR} x the reordered "
          f"plain version's {re_gap['max_abs_diff']}")
    out["prefill_last_logits_vs_plain"] = gap
    print(f"RGLRU_ASSOC {cfg.name} sequential "
          f"{out['sequential_prefill_ms']:.1f} ms, assoc "
          f"{out['assoc_prefill_ms']:.1f} ms, block h gap {h_gap:.3e}",
          flush=True)
    return out


def _logit_gap(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """(B, vocab) logits of a kernel run against the plain run's: the
    largest difference, the plain logits' scale (max abs, and the standard
    deviation over the vocab, averaged over rows) and whether the argmax
    agrees."""
    return dict(max_abs_diff=float((got - ref).abs().max()),
                max_abs_logit=float(ref.abs().max()),
                logit_std=float(ref.std(dim=-1).mean()),
                argmax_equal=bool(torch.equal(got.argmax(-1),
                                              ref.argmax(-1))))


@contextlib.contextmanager
def _plain_reordered():
    """``attn_flash`` as its plain version at another float order (kv
    blocks of 128 rows, not 512: another order of the online softmax's
    sums), whatever the caller asks: an equally valid plain result."""
    from repro_torch.kernels import attn_flash as A

    orig = A.attn_flash
    A.attn_flash = lambda q, k, v, reference=False, **kw: (
        A.attn_flash_plain(q, k, v, block_kv=128, **kw))
    try:
        yield
    finally:
        A.attn_flash = orig


def _family_continuous(arch, params, cfg) -> dict:
    """The LM main path's continuous mix (CONT_REQUESTS requests, CONT_*
    prompts, horizons and pages) through ``ContinuousLMEngine``: counted
    and timed, then the same requests on the kernels' plain versions
    (tokens and margins) and again on the kernels with every call held in
    context (their tokens the counted run's, bit for bit); each request's
    first difference from the plain run reported with its margin."""
    from repro_torch.kernels import _lib

    payloads = _cont_payloads(np.random.RandomState(FAM_SEED + 1),
                              cfg.vocab)
    eng = _cont_engine(params, cfg)
    eng.serve([(payloads[0][0][:CONT_PAGE], 2)])     # warm-up, not counted
    torch.cuda.synchronize()
    c0, steps0 = eng.stats["dispatches"], eng.stats["steps"]
    _lib.reset_launches()
    t0 = time.perf_counter()
    res = eng.serve(payloads)
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    disp = eng.stats["dispatches"] - c0
    steps, pool = eng.stats["steps"] - steps0, eng.pool.stats()
    del eng
    want = {k: 0 for k in launches}
    want["attn_paged"] = cfg.n_layers * disp
    check(launches == want, f"{arch} continuous: launches {launches} != "
                            f"{want}")
    ref = _cont_engine(params, cfg, reference=True,
                       record_margins=True).serve(payloads)
    with _InContext() as ctx:
        again = _cont_engine(params, cfg).serve(payloads)
    held = dict(positions=0, divergences=[])
    for i, (r, a, o) in enumerate(zip(res, again, ref)):
        check(len(r.value) == payloads[i][1]
              and bool(np.all((r.value >= 0) & (r.value < cfg.vocab))),
              f"{arch} continuous request {i}: {len(r.value)} tokens or "
              f"outside the vocab")
        check(np.array_equal(r.value, a.value), f"{arch} continuous "
              f"request {i}: the in-context run's tokens differ")
        h = _hold_tokens(f"{arch} continuous request {i} vs plain", r.value,
                         o.value, o.margins, None)
        held["positions"] += h["positions"]
        held["divergences"] += [dict(d, request=i) for d in h["divergences"]]
    emitted = sum(len(r.value) for r in res)
    lat = sorted(r.latency_s for r in res)
    return dict(requests=CONT_REQUESTS, slots=CONT_SLOTS,
                page_size=CONT_PAGE, pages=CONT_PAGES,
                table_pages=-(-(CONT_PROMPTS[1] + CONT_HORIZONS[1])
                              // CONT_PAGE),
                prompt_tokens=sum(len(p[0]) for p in payloads),
                emitted_tokens=emitted, dispatches=disp, steps=steps,
                launches={k: v for k, v in launches.items() if v},
                kernels_in_context=ctx.report(f"{arch} continuous"),
                wall_s=wall, requests_per_s=CONT_REQUESTS / wall,
                tokens_per_s=emitted / wall,
                p50_latency_ms=1e3 * lat[len(lat) // 2],
                p99_latency_ms=1e3 * lat[-1], pool=pool, vs_plain=held)


class _InContext:
    """Holds every ``attn_flash`` / ``attn_paged`` call a run makes
    against the plain version on the same inputs (the model's own q, k,
    v, pools and tables), within one bfloat16 rounding (ATTN_TOL_BF16 x
    max|v|), while the run goes on with the kernel's output: the kernels
    checked in context, where end-to-end tokens cannot separate a kernel
    fault from the network's own sensitivity."""

    def __init__(self):
        from repro_torch.kernels import attn_flash as A

        self.A, self.calls, self.worst = A, {}, 0.0
        self.orig = (A.attn_flash, A.attn_paged)

    def _wrap(self, name, fn, vpos):
        def shadow(*args, **kw):
            out = fn(*args, **kw)
            ref = fn(*args, **dict(kw, reference=True))
            v = args[vpos]
            worst = float((out.float() - ref.float()).abs().max()) / (
                ATTN_TOL_BF16 * float(v.float().abs().max()))
            self.calls[name] = self.calls.get(name, 0) + 1
            self.worst = max(self.worst, worst)
            return out
        return shadow

    def __enter__(self):
        self.A.attn_flash = self._wrap("attn_flash", self.orig[0], 2)
        self.A.attn_paged = self._wrap("attn_paged", self.orig[1], 2)
        return self

    def __exit__(self, *exc):
        self.A.attn_flash, self.A.attn_paged = self.orig

    def report(self, tag: str) -> dict:
        check(self.worst <= 1.0, f"{tag}: a kernel call in context is "
                                 f"{self.worst} x its tolerance from its "
                                 f"plain version")
        return dict(calls=self.calls, worst_over_tol=self.worst)


def families_phase(card: str) -> dict:
    """The dense, MoE and recurrent architectures at W1A8, bf16, random
    weights from FAM_SEED, one after another (each freed before the
    next): a bucket of FAM_BATCH prompts through ``ServeEngine`` +
    ``LMRunner`` (flash prefill on every attention layer at 2048 tokens;
    RWKV-6 runs no kernel), phi3-mini's continuous mix through
    ``ContinuousLMEngine`` (``attn_paged`` at hd 96) and one of its decode
    steps under the profiler; launches checked, every kernel call held to
    its plain version in context, each side's rerun bit for bit, the
    prefill logits' gap held to the reordered plain version's
    (FAM_GAP_FACTOR), the tokens compared with the plain run and
    reported, the continuous engine's refusal of every other pattern
    recorded.  One ``FAMILIES`` line."""
    t_phase = time.perf_counter()
    archs = []
    for arch, cut, prompt_len, new, continuous in FAMILIES:
        t0 = time.perf_counter()
        r = _family_run(arch, cut, prompt_len, new, continuous)
        r["seconds"] = time.perf_counter() - t0
        print(f"FAMILY {arch} {r['seconds']:.1f} s", json.dumps(r),
              flush=True)
        archs.append(r)
    report = dict(card=card, quant="w1a8", compute_dtype="bfloat16",
                  archs=archs, seconds=time.perf_counter() - t_phase)
    print("FAMILIES", json.dumps(report), flush=True)
    return report


def _modality_run(arch: str, cut) -> dict:
    """One architecture of the modalities phase (see ``modalities_phase``)."""
    import gc

    from repro_torch.configs import SINGLE
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import greedy_token, grow_cache, top2_margin
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import resolve_attn_engine

    dev = torch.device("cuda")
    cfg, params, drawn = _served_model(arch, cut)
    seq = MOD_FRAMES if cfg.frame_input else cfg.n_patches + MOD_TEXT
    out = dict(arch=arch, family=cfg.family, layers=cfg.n_layers,
               width=cfg.d_model, head_dim=cfg.hd, causal=cfg.causal,
               batch=FAM_BATCH, positions=seq, **drawn)
    out["attention_engine"] = resolve_attn_engine(
        cfg, seq_q=seq, seq_kv=seq, heads=SINGLE.padded_heads(cfg.n_heads),
        causal=cfg.causal, window=None, qmode="serve")
    check(out["attention_engine"] == "flash",
          f"{arch}: the prefill routes {out['attention_engine']}, not flash")
    rs = np.random.RandomState(FAM_SEED)
    if cfg.frame_input:
        inp = dict(frame_feats=torch.from_numpy(rs.randn(
            FAM_BATCH, MOD_FRAMES, cfg.frame_dim).astype(np.float32)).to(dev))
        out["inputs"] = f"frame_feats ({FAM_BATCH}, {MOD_FRAMES}, " \
                        f"{cfg.frame_dim}) float32"
    else:
        inp = dict(patch_embeds=torch.from_numpy(rs.randn(
            FAM_BATCH, cfg.n_patches, cfg.vit_dim).astype(np.float32)).to(dev),
            tokens=torch.from_numpy(rs.randint(
                0, cfg.vocab, (FAM_BATCH, MOD_TEXT)).astype(np.int32)).to(dev))
        out["inputs"] = (f"patch_embeds ({FAM_BATCH}, {cfg.n_patches}, "
                         f"{cfg.vit_dim}) float32 + tokens ({FAM_BATCH}, "
                         f"{MOD_TEXT}), then {MOD_NEW} greedy tokens")
    layers = T.unstack_layers(params, cfg)

    def run(reference: bool = False, margins=None):
        """The encoder: every frame's logits (B * T, vocab).  The VLM: the
        prefill's last logits (B, vocab) and MOD_NEW greedy tokens, the
        decode going on at position n_patches + MOD_TEXT."""
        logits, cache = T.prefill(params, cfg, SINGLE, layers=layers,
                                  reference=reference, **inp)
        if cfg.frame_input:
            got = logits[..., :cfg.vocab].float().reshape(-1, cfg.vocab)
            check(bool(torch.isfinite(got).all()), f"{arch}: logits")
            return got, None
        last = logits[:, -1, :cfg.vocab].float()
        check(bool(torch.isfinite(last).all()), f"{arch}: prefill logits")
        tok = greedy_token(logits, cfg.vocab)
        if margins is not None:
            margins.append(top2_margin(logits, cfg.vocab))
        del logits
        cache = grow_cache(cache, seq, seq + MOD_NEW)
        toks = [tok]
        for i in range(MOD_NEW - 1):
            lg, cache = T.decode_step(params, cache, tok, seq + i, cfg,
                                      SINGLE, layers=layers,
                                      reference=reference)
            tok = greedy_token(lg, cfg.vocab)
            toks.append(tok)
            if margins is not None:
                margins.append(top2_margin(lg, cfg.vocab))
        return last, torch.cat(toks, dim=1)

    run()                                            # warm-up, not counted
    torch.cuda.synchronize()
    # ---- this architecture's path, counted
    _lib.reset_launches()
    t0 = time.perf_counter()
    got, got_tok = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    # ----
    want = {k: 0 for k in launches}
    want["attn_flash"] = cfg.n_blocks_of("attn")
    check(launches == want, f"{arch}: launches {launches} != {want}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T.prefill(params, cfg, SINGLE, layers=layers, **inp)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    # each side run again, bit for bit
    again, again_tok = run()
    margins = []
    ref, ref_tok = run(reference=True, margins=margins)
    ref2, ref2_tok = run(reference=True)
    check(torch.equal(again, got) and torch.equal(ref2, ref),
          f"{arch}: a rerun's logits differ from the first run's")
    with _InContext() as ctx:
        ctx_out, ctx_tok = run()
    check(torch.equal(ctx_out, got), f"{arch}: the in-context run's logits "
                                     f"are not the counted run's")
    # the witness: the plain version at another float order
    with _plain_reordered():
        reo, reo_tok = run(reference=True)
    gap, re_gap = _logit_gap(got, ref), _logit_gap(reo, ref)
    check(gap["max_abs_diff"] <= FAM_GAP_FACTOR * re_gap["max_abs_diff"],
          f"{arch}: the kernels move the logits by {gap['max_abs_diff']}, "
          f"over {FAM_GAP_FACTOR} x the reordered plain version's "
          f"{re_gap['max_abs_diff']}")
    what = "every frame's logits" if cfg.frame_input else "the prefill's " \
                                                          "last logits"
    out.update(
        launches={k: v for k, v in launches.items() if v},
        wall_s=wall, prefill_ms=1e3 * prefill_s,
        prefill_positions_per_s=FAM_BATCH * seq / prefill_s,
        kernels_in_context=ctx.report(arch),
        oracle=("the same entry points on the attention kernels' plain "
                "versions; each side run twice, bit for bit"),
        logits_compared=what, logits_vs_plain=gap,
        plain_reordered_vs_plain=dict(logits=re_gap))
    if cfg.frame_input:
        agree = lambda a: float((a.argmax(-1) == ref.argmax(-1))  # noqa: E731
                                .float().mean())
        out["frame_argmax_agreement"] = agree(got)
        out["plain_reordered_vs_plain"]["frame_argmax_agreement"] = agree(reo)
    else:
        check(torch.equal(again_tok, got_tok) and torch.equal(ref2_tok, ref_tok)
              and torch.equal(ctx_tok, got_tok),
              f"{arch}: a rerun's tokens differ from the first run's")
        margins = torch.stack(margins, dim=1).cpu().numpy()
        g, r = got_tok.cpu().numpy(), ref_tok.cpu().numpy()
        check(g.shape == (FAM_BATCH, MOD_NEW)
              and bool(np.all((g >= 0) & (g < cfg.vocab))),
              f"{arch}: tokens {g.shape} or outside the vocab")
        out["tokens_per_s"] = FAM_BATCH * MOD_NEW / wall
        out["vs_plain"] = _hold_tokens(f"{arch} vs plain", g, r, margins,
                                       None)
        out["plain_reordered_vs_plain"]["tokens"] = _hold_tokens(
            f"{arch} reordered plain vs plain", reo_tok.cpu().numpy(), r,
            margins, None)
    del params, layers, got, again, ref, ref2, ctx_out, reo
    gc.collect()
    torch.cuda.empty_cache()
    return out


def modalities_phase(card: str) -> dict:
    """The encoder and VLM families at W1A8, bf16, random weights from
    FAM_SEED, one after the other: hubert-xlarge's 2048 frames a row
    through ``prefill(frame_feats=)`` (non-causal ``attn_flash`` at hd 80
    on all 48 layers) and internvl2-26b's 256 patches + 1792 tokens a row
    through ``prefill(patch_embeds=, tokens=)`` and ``decode_step`` (8 of
    48 layers, hd 128 after GQA expansion); launches checked, every
    kernel call held to its plain version in context, each side's rerun
    bit for bit, the logits' gap held to the reordered plain version's
    (FAM_GAP_FACTOR), per-frame argmax agreement and tokens reported.
    One ``FAMILY`` line each."""
    archs = []
    for arch, cut in (("hubert-xlarge", None),
                      ("internvl2-26b", MOD_VLM_LAYERS)):
        t0 = time.perf_counter()
        r = _modality_run(arch, cut)
        r["seconds"] = time.perf_counter() - t0
        print(f"FAMILY {arch} {r['seconds']:.1f} s", json.dumps(r),
              flush=True)
        archs.append(r)
    return dict(card=card, archs=archs)


def fleet_study(specs) -> tuple:
    """The seeded fleet study on ``specs`` (host only, a pure function of
    them and the FLEET_* constants): traces, Table-I SLOs, frame costs
    from structure-only plans, the co-design search and the fleet report.
    Returns ``(report, traces, assignments, results)``."""
    from repro_torch import fleet

    traces = [fleet.make_trace(s) for s in specs]
    out = fleet.codesign(traces, fleet.assign_slos(len(specs),
                                                   seed=FLEET_SLO_SEED),
                         costs=fleet.frame_cost_table(),
                         node_kw=dict(resume_us=FLEET_RESUME_US))
    results = out.pop("results")
    report = dict(fleet=fleet.fleet_report(results, specs), codesign={
        k: out[k] for k in ("inferences_per_day", "baseline",
                            "win_vs_baseline", "slo_violations")})
    return report, traces, out["assignments"], results


def fleet_phase(card: str) -> dict:
    """The fleet simulator: the seeded study of FLEET_NODES nodes, the same
    study in a fresh CPU-only interpreter from the specs' JSON (reports
    equal, byte for byte), then the busiest node's outage schedule,
    compressed onto the replay's work, through the port's
    ResilientServeEngine on the card (``live_validation(device="cuda")``:
    integer counters exact, floats within FLEET_TOL of the simulator's
    engine-accounting mirror).  One ``FLEET`` line."""
    import shutil
    import tempfile

    from repro_torch import fleet

    t0 = time.perf_counter()
    specs = fleet.generate_fleet(FLEET_NODES, seed=FLEET_SEED)
    report, traces, assignments, results = fleet_study(specs)
    study_s = time.perf_counter() - t0
    check(report["codesign"]["slo_violations"] == 0,
          "fleet: a node misses its SLO")
    t0 = time.perf_counter()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    cpu = subprocess.run(
        [sys.executable, "-c", FLEET_CPU_RUN, ROOT], env=env, check=True,
        input=json.dumps([s.to_json() for s in specs]), capture_output=True,
        text=True, timeout=300).stdout.strip().splitlines()[-1]
    cpu_s = time.perf_counter() - t0
    check(cpu == json.dumps(report, sort_keys=True),
          "fleet: the CPU-only run's report differs from the study's")
    # the busiest node's outages, compressed onto ~80% of the replay's
    # fault-free work so the kills land mid-decode
    idx = max(range(len(results)), key=lambda i: results[i]["failures"])
    a = assignments[idx]
    e, lat = fleet.frame_cost_table(quants=(a["quant"],),
                                    targets=(a["target"],))[(a["quant"],
                                                             a["target"])]
    node = fleet.NodeConfig(node_id=a["node_id"], quant=a["quant"],
                            target=a["target"], period=a["period"],
                            frame_energy_uj=e, frame_time_us=lat,
                            resume_us=FLEET_RESUME_US)
    outages = fleet.simulate_node(traces[idx], node,
                                  collect_outages=FLEET_OUTAGES)[
                                      "outage_frames"]
    rp = FLEET_REPLAY
    work = 0.8 * (-(-rp["n_requests"] // rp["max_batch"])) * (
        0.25 + 1.0 + sum(fleet.epoch_schedule(rp["new_tokens"],
                                              rp["epoch_steps"])))
    sched = (fleet.rescale_outages(outages, outages[-1], work)
             if outages else [])
    check(len(sched) > 0, "fleet: the busiest node has no outage")
    ckdir = tempfile.mkdtemp(prefix="fleet_val_")
    t0 = time.perf_counter()
    try:
        v = fleet.live_validation(sched, checkpoint_dir=ckdir, tol=FLEET_TOL,
                                  device="cuda", **rp)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    val_s = time.perf_counter() - t0
    int_d = {k: v["deltas"][k] for k in fleet.sim._VALIDATE_INT_KEYS}
    float_d = {k: v["deltas"][k] for k in v["deltas"] if k not in int_d}
    check(v["ok"] and v["device"].startswith("cuda"),
          f"fleet: live validation on the card failed: {v['deltas']}")
    check(all(d == 0 for d in int_d.values())
          and all(abs(d) <= FLEET_TOL for d in float_d.values()),
          f"fleet: live validation deltas {v['deltas']}")
    line = dict(card=card, nodes=FLEET_NODES, seed=FLEET_SEED,
                report=report, cpu_run_equal=True,
                validation=dict(node_id=a["node_id"], outages=len(sched),
                                completed=v["completed"],
                                dead_letters=v["dead_letters"],
                                device=v["device"], measured=v["measured"],
                                integer_deltas=int_d, float_deltas=float_d,
                                efficiency_measured=v["efficiency_measured"],
                                efficiency_predicted=v["efficiency_predicted"]),
                host_s=dict(study=study_s, cpu_run=cpu_s, validation=val_s))
    print("FLEET", json.dumps(line), flush=True)
    return line


def _first_step_vs_cpu(params, batch, spec, quant, dev="cuda") -> dict:
    """The CNN's first training step on the card against the same step on
    the CPU, layer by layer with teacher forcing, as the CPU tests hold
    the port to the reference's inputs: each card layer takes the CPU
    layer's input and the CPU's gradient of its output.  Held, at every
    layer: the pre-rounding activation (conv, bias, norm, clip) and the
    output within TRAIN_ACT_TOL x their max; each gradient leaf and the
    input's gradient within TRAIN_GRAD_TOL x its max|g| (a bias the batch
    norm cancels: x the tree's max|g|, its exact gradient being zero);
    the loss of the card's last layer within TRAIN_LOSS_TOL.  A level
    flip (the two pre-rounding values on either side of a level boundary)
    is pinned: within TRAIN_FLIP_MARGIN of the boundary, and the output
    off by more than its tolerance at no more elements than there are
    flips, by at most a level."""
    import dataclasses

    from repro_torch.models import cnn

    fp = dataclasses.replace(quant, engine="fp")
    n = (1 << quant.a_bits) - 1
    last = len(spec) - 1
    x = torch.from_numpy(batch["image"])
    labels = torch.from_numpy(batch["label"])
    host = [{k: v.detach().cpu().requires_grad_() for k, v in p.items()}
            for p in params]
    card = [{k: v.detach().to(dev).requires_grad_() for k, v in p.items()}
            for p in params]

    def acts(p, s, h):      # the clipped value before the level rounding
        with torch.no_grad():
            return cnn._norm_act(cnn.conv_bias(p, s, h, quant), p["g"],
                                 p["beta"], fp, s.role, "train")

    def grad(out, leaves, up):    # zeros for the last layer's unused norm
        gs = torch.autograd.grad(out, leaves, up, allow_unused=True)
        return [torch.zeros_like(v) if g is None else g
                for v, g in zip(leaves, gs)]

    ins, outs, h = [], [], x
    for i, (p, s) in enumerate(zip(host, spec)):
        h = h.detach().requires_grad_(i > 0)
        ins.append(h)
        h = cnn.cnn_layer(p, s, h, quant, i == last)
        outs.append(h)
    loss_c, _ = cnn.xent(torch.mean(outs[-1], dim=(1, 2)), labels)
    ups = [None] * len(spec)
    ups[last], = torch.autograd.grad(loss_c, outs[-1])
    g_host, g_in = [None] * len(spec), [None] * len(spec)
    for i in range(last, -1, -1):
        leaves = list(host[i].values()) + ([ins[i]] if i else [])
        gs = grad(outs[i], leaves, ups[i])
        g_host[i] = dict(zip(host[i], gs))
        if i:
            g_in[i] = ups[i - 1] = gs[-1]
    gmax = max(float(g.abs().max()) for gl in g_host for g in gl.values())

    def rel(a, b, scale=None):
        b = b.detach()
        err = float((a.detach().cpu() - b).abs().max())
        return err / max(float(b.abs().max()) if scale is None else scale,
                         1e-30)

    layers = []
    for i, (p, s) in enumerate(zip(card, spec)):
        hin = ins[i].detach().to(dev).requires_grad_(i > 0)
        out = cnn.cnn_layer(p, s, hin, quant, i == last)
        leaves = list(p.values()) + ([hin] if i else [])
        gs = dict(zip(list(p) + ["input"],
                      grad(out, leaves, ups[i].to(dev))))
        ref = dict(g_host[i], input=g_in[i]) if i else g_host[i]
        g_rel = max(rel(gs[k], ref[k], gmax if (k == "b" and i < last)
                        else None) for k in ref)
        check(g_rel <= TRAIN_GRAD_TOL,
              f"train: first step, layer {i}'s gradients {g_rel:.3g} x "
              f"max|g| apart (card vs cpu)")
        row = dict(layer=i, grad_rel=g_rel)
        diff = (out.detach().cpu() - outs[i].detach()).abs()
        tol = TRAIN_ACT_TOL * float(outs[i].detach().abs().max())
        flips = 0
        if i < last:
            a, b = acts(p, s, hin).cpu(), acts(host[i], s, ins[i])
            row["act_rel"] = rel(a, b)
            check(row["act_rel"] <= TRAIN_ACT_TOL,
                  f"train: first step, layer {i}'s activations "
                  f"{row['act_rel']:.3g} apart (card vs cpu)")
            if quant.engine != "fp" and s.role != "last":
                flip = torch.round(a * n) != torch.round(b * n)
                flips = int(flip.sum())
                if flips:
                    frac = (b[flip] * n).double()
                    margin = float(((frac - frac.floor()) - 0.5).abs().max())
                    row["flips"] = dict(n=flips, max_margin_levels=margin)
                    check(margin < TRAIN_FLIP_MARGIN,
                          f"train: first step, layer {i}'s levels differ "
                          f"away from a boundary ({margin:.3g} levels)")
        off = int((diff > tol).sum())
        row["out_rel"] = float(diff.max()) / max(tol / TRAIN_ACT_TOL, 1e-30)
        check(off <= flips and float(diff.max()) <= tol + 1.0 / n,
              f"train: first step, layer {i}'s output off at {off} "
              f"elements by up to {float(diff.max()):.3g} with {flips} "
              f"level flips (card vs cpu)")
        layers.append(row)
        if i == last:
            loss_g, _ = cnn.xent(torch.mean(out, dim=(1, 2)),
                                 labels.to(dev))
    loss_g, loss_c = float(loss_g.detach()), float(loss_c.detach())
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    check(loss_rel <= TRAIN_LOSS_TOL,
          f"train: first-step loss {loss_rel:.3g} apart (card vs cpu)")
    return dict(loss_card=loss_g, loss_cpu=loss_c,
                loss_rel=loss_rel, layers=layers)


def train_phase(card: str) -> dict:
    """The train phase, one ``TRAIN`` line: (1) the paper's CNN at full
    width under power failures (golden vs chaotic run bit for bit on the
    card, first step vs the CPU); (2) the trained CNN compiled and served
    on ``conv_implicit`` and ``fused_qgemm``, equal to the plain versions
    bit for bit, with no port kernel launched by training; (3)
    SmolLM-360M W1A8 at full width through ``Trainer``: finite and
    falling loss, checkpoints at steps 10 and 20, a fresh trainer's
    restore bit for bit on the card, two steps with compressed gradients;
    (4) ms per step, host wall against device time, peak memory."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch import api
    from repro_torch.configs import SINGLE, get_config
    from repro_torch.core.quant import W1A4, W1A8
    from repro_torch.data.synthetic import lm_batch, svhn_like
    from repro_torch.kernels import _lib
    from repro_torch.models import cnn
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.intermittent import (IntermittentConfig,
                                                IntermittentTrainer,
                                                deterministic_algorithms,
                                                run_with_failures)
    from repro_torch.train.optimizer import OptConfig, tree_leaves
    from repro_torch.train.trainer import TrainConfig, Trainer, to_device

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_phase_",
                            dir=os.path.join(ROOT, "build"))
    line: dict = dict(card=card)
    try:
        # (1) the paper's CNN under power failures
        c = TRAIN_CNN
        spec = cnn.svhn_cnn_spec(c["channels"])

        def batch_fn(step, micro):
            x, y = svhn_like(c["batch"], seed=step * 31 + micro)
            return dict(image=x, label=y)

        def loss_fn(p, b):
            return cnn.cnn_loss(p, b, spec, W1A4)

        init = cnn.init_cnn(torch.Generator(device=dev).manual_seed(0), spec)
        ocfg = OptConfig(lr=3e-3, warmup_steps=2, total_steps=c["steps"])
        icfg = IntermittentConfig(accum_steps=4, snapshot_every=2,
                                  full_every=2)

        def make(tag, fail_at=None):
            params = [{k: v.clone() for k, v in p.items()} for p in init]
            return IntermittentTrainer(
                loss_fn, params, ocfg, batch_fn,
                Checkpointer(os.path.join(root, tag), keep=3,
                             async_save=False), icfg, fail_at=fail_at)

        t0 = time.perf_counter()
        with deterministic_algorithms():
            line["cnn_first_step"] = _first_step_vs_cpu(
                init, batch_fn(0, 0), spec, W1A4)
            _lib.reset_launches()
            golden = make("golden")
            golden.train(c["steps"])
            fails = set(TRAIN_CNN_FAILS)
            chaotic, out, restarts = run_with_failures(
                lambda: make("chaotic", fails), c["steps"])
            torch.cuda.synchronize()
        train_launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
        check(restarts == len(TRAIN_CNN_FAILS) and not fails,
              f"train: {restarts} restarts for {len(TRAIN_CNN_FAILS)} faults")
        check(all(a.device.type == "cuda" and torch.equal(a, b)
                  for a, b in zip(tree_leaves(golden.params),
                                  tree_leaves(chaotic.params))),
              "train: the chaotic CNN run's params differ from the golden "
              "run's")
        check(not train_launches,
              f"train: CNN training launched port kernels {train_launches}")
        line["cnn_intermittent"] = dict(
            spec=f"svhn_cnn_spec({c['channels']})", quant="w1a4",
            batch=c["batch"], steps=c["steps"], accum_steps=4,
            faults=sorted(TRAIN_CNN_FAILS), restarts=restarts,
            bit_identical=True, final_loss=out["loss"],
            seconds=time.perf_counter() - t0)

        # (2) the trained CNN served on the card's kernels
        trained = [{k: v.detach() for k, v in p.items()}
                   for p in chaotic.params]
        compiled = api.build(spec, W1A4, params=trained,
                             img_hw=40).compile(target="cuda")
        x, y = svhn_like(c["images"], seed=99)
        xt = torch.from_numpy(x).to(dev)
        _lib.reset_launches()
        logits = compiled.forward(xt)
        torch.cuda.synchronize()
        serve_launches = dict(_lib.LAUNCHES)
        ref = compiled.forward(xt, reference=True)
        check({k: v for k, v in serve_launches.items() if v}
              == TRAIN_SERVE_LAUNCHES,
              f"train: the served CNN launched {serve_launches}, not "
              f"{TRAIN_SERVE_LAUNCHES}")
        vs_plain = _held_to_plain(
            "train: the served CNN vs plain", logits.cpu().numpy(),
            ref.cpu().numpy(), lambda: compiled.forward(xt).cpu().numpy())
        with torch.no_grad():
            float_logits = cnn.cnn_forward(trained, xt, spec, W1A4)
        line["handoff"] = dict(
            launches={k: v for k, v in serve_launches.items() if v},
            vs_plain=vs_plain,
            served_acc=float((logits.argmax(-1).cpu().numpy() == y).mean()),
            train_forward_acc=float(
                (float_logits.argmax(-1).cpu().numpy() == y).mean()))
        del golden, chaotic, trained, compiled

        # (3) SmolLM-360M at full width
        L = TRAIN_LM
        cfg = dataclasses.replace(get_config("smollm-360m"), quant=W1A8)
        lm_dir = os.path.join(root, "lm")
        ocfg = OptConfig(lr=L["lr"], warmup_steps=L["warmup"],
                         total_steps=L["steps"])

        def lm_fn(s, m):
            return lm_batch(s, m, batch=L["batch"], seq=L["seq"],
                            vocab=L["data_vocab"], seed=0)

        t0 = time.perf_counter()
        tr = Trainer(cfg, SINGLE, ocfg,
                     TrainConfig(steps=L["steps"], log_every=1,
                                 ckpt_every=L["ckpt_every"]),
                     ckpt_dir=lm_dir, device=dev)
        n_params = sum(p.numel() for p in tree_leaves(tr.params))
        step_ms = []
        inner = tr.train_step

        def timed_step(batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = inner(batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            return m

        tr.train_step = timed_step
        _lib.reset_launches()
        hist = tr.run(lm_fn, log=lambda *_: None)
        lm_launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
        tr.train_step = inner
        losses = [h["loss"] for h in hist]
        check(len(losses) == L["steps"]
              and all(np.isfinite(v) for v in losses),
              f"train: SmolLM losses {losses}")
        line["smollm_losses"] = losses
        check(losses[-1] < losses[0],
              f"train: SmolLM loss did not fall ({losses[0]} -> "
              f"{losses[-1]})")
        check(not lm_launches,
              f"train: LM training launched port kernels {lm_launches}")
        check(Checkpointer(lm_dir).latest_step() == L["steps"],
              "train: no checkpoint at the last step")
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr2 = Trainer(cfg, SINGLE, ocfg, TrainConfig(steps=L["steps"]),
                      ckpt_dir=lm_dir, device=dev)
        check(tr2.restore() and tr2.step == L["steps"],
              "train: a fresh trainer did not restore the last step")
        check(all(b.device.type == "cuda" and torch.equal(a, b)
                  for a, b in zip(tree_leaves(tr.params),
                                  tree_leaves(tr2.params))),
              "train: the restored SmolLM params differ")
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(tr.opt_state), tree_leaves(tr2.opt_state))),
              "train: the restored optimizer state differs")
        restore_s = time.perf_counter() - t0
        del tr2
        torch.cuda.empty_cache()
        batch = to_device(lm_fn(L["steps"], 0), dev)
        prof = profile_forward(lambda: tr.train_step(batch), 1)
        del tr
        torch.cuda.empty_cache()
        n = L["steps"] + L["compressed_steps"]
        tr3 = Trainer(cfg, SINGLE, ocfg,
                      TrainConfig(steps=n, log_every=1, ckpt_every=10_000,
                                  compress_grads=True),
                      ckpt_dir=lm_dir, device=dev)
        check(tr3.restore(), "train: the compressed run did not restore")
        chist = tr3.run(lm_fn, log=lambda *_: None)
        check([h["step"] for h in chist] == list(range(L["steps"] + 1, n + 1))
              and all(np.isfinite(h["loss"]) for h in chist),
              f"train: compressed steps {chist}")
        del tr3
        timed = step_ms[L["timed_from"] - 1:]
        line["smollm"] = dict(
            arch="smollm-360m", quant="w1a8", params=n_params,
            compute_dtype=str(cfg.compute_dtype), remat=cfg.remat,
            batch=L["batch"], seq=L["seq"], data_vocab=L["data_vocab"],
            steps=L["steps"], loss_first=losses[0], loss_last=losses[-1], losses=losses,
            ms_per_step_median=float(np.median(timed)),
            ms_per_step_min=float(np.min(timed)),
            ms_per_step_steps=f"{L['timed_from']}-{L['steps']}",
            run_s=run_s, restore_s=restore_s, restore_bit_identical=True,
            compressed_losses=[h["loss"] for h in chist],
            one_step_profile=prof)
        line["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    except BaseException:
        print("TRAIN-PARTIAL", json.dumps(line, default=str), flush=True)
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line["seconds"] = time.perf_counter() - t_phase
    print("TRAIN", json.dumps(line), flush=True)
    return line


DIST_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
line = chip_smoke.dist_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
if int(sys.argv[2]) == 0:
    with open(sys.argv[5], "w") as f:
        json.dump(line, f)
    sys.exit(1 if line["failures"] else 0)
"""


def _named(tree, path=""):
    """``(path, leaf)`` of a param tree, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{path}/{i}")
    else:
        yield path, tree


def _nbytes(trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees
               for _, t in _named(tree) if torch.is_tensor(t))


def _grad_gap(got, want, tol: float) -> dict:
    """Leaf by leaf, max|got - want| over the leaf's max|want|: the
    largest such ratio and its leaf, the median and the least over the
    leaves, and how many leaves exceed ``tol``."""
    rel = {}
    for (k, a), (k2, b) in zip(_named(got), _named(want), strict=True):
        assert k == k2, (k, k2)
        scale = float(b.float().abs().max()) if b.numel() else 0.0
        d = float((a.float() - b.float()).abs().max()) if b.numel() else 0.0
        rel[k] = d / max(scale, 1e-30)
    worst = max(rel, key=rel.get)
    return dict(max_rel=rel[worst], worst_leaf=worst,
                median_rel=float(np.median(list(rel.values()))),
                min_rel=min(rel.values()),
                leaves=len(rel), leaves_over_tol=sum(v > tol
                                                     for v in rel.values()),
                tol=tol)


def _max_abs_diff(a, b) -> float:
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for (_, x), (_, y) in zip(_named(a), _named(b), strict=True))


def _hold_trainer(tag: str, run: dict, ref: dict, split: bool,
                  fails: list) -> dict:
    """A mesh trainer's run against the meshless run's from the same params
    and batches (``ref``: its losses, final params and step-1 gradients):
    step 1's gradients leaf by leaf, each step's params against the
    meshless optimizer fed the run's own gradients (``run["opt_gap"]``),
    the losses, and at world 1 (``split`` false) the params.  Appends
    what failed to ``fails``; returns the readings."""
    grad_tol = DIST_SPLIT_GRAD_TOL if split else TRAIN_GRAD_TOL
    loss_tol = DIST_SPLIT_LOSS_TOL if split else TRAIN_LOSS_TOL
    grads = _grad_gap(run["grads0"], ref["grads0"], grad_tol)
    if grads["max_rel"] > grad_tol:
        fails.append(f"{tag}: step 1's gradient {grads['worst_leaf']} "
                     f"{grads['max_rel']} x max|g| from the meshless run's "
                     f"(> {grad_tol})")
    opt_gap = max(run["opt_gap"])
    if opt_gap > DIST_STEP_TOL:
        fails.append(f"{tag}: params {run['opt_gap']} from the meshless "
                     f"optimizer on the run's own gradients "
                     f"(> {DIST_STEP_TOL})")
    rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                  ref["losses"]))
    if rel > loss_tol:
        fails.append(f"{tag}: losses {run['losses']} vs meshless "
                     f"{ref['losses']} (relative {rel} > {loss_tol})")
    d = _max_abs_diff(run["params"], ref["params"])
    if not split and d > DIST_STEP_TOL:
        fails.append(f"{tag}: params {d} from the meshless run's "
                     f"(> {DIST_STEP_TOL})")
    return dict(losses=run["losses"], meshless_losses=ref["losses"],
                loss_rel_diff=rel, loss_tol=loss_tol, step1_grads=grads,
                opt_gap_per_step=run["opt_gap"], opt_tol=DIST_STEP_TOL,
                param_max_abs_diff=d,
                param_tol=None if split else DIST_STEP_TOL,
                bit_identical=bool(rel == 0.0 and d == 0.0
                                   and grads["max_rel"] == 0.0))


def dist_rank(rank: int, world: int, rdv: str) -> dict:
    """One rank of the DIST phase's trainer run (a child process a card,
    NCCL over ``world`` ranks): SmolLM-360M W1A8 at full width and depth
    (bf16, remat) for DIST_TRAIN steps through the meshless ``Trainer``
    (rank 0) and through ``Trainer(mesh=)`` on a ``(world, 1)`` mesh from
    the same params and batches, held to each other (``_hold_trainer``;
    the planted fault, DIST_FAULT_ROWS rows' gradient, must fail the split
    bound); the compressed all-reduce over the NCCL group on the mesh
    trainer's gradients, held to the local path at world 1; with four or
    more cards the trainer at ``(world / 2, 2)`` and the pipeline at S = 4
    too.  Returns rank 0's report, with what failed under ``failures``."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import SINGLE, get_config, make_plan
    from repro_torch.core.quant import W1A8
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _lib
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.compression import compressed_allreduce
    from repro_torch.train.optimizer import OptConfig, tree_leaves
    from repro_torch.train.trainer import TrainConfig, Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=rank,
                            world_size=world, device_id=dev)
    L = DIST_TRAIN
    cfg = dataclasses.replace(get_config("smollm-360m"), quant=W1A8)
    ocfg = OptConfig(lr=L["lr"], warmup_steps=L["warmup"],
                     total_steps=L["steps"])
    fails: list = []
    held: dict = {}     # the checks' trees on this card, out of the peaks

    def batch(s, rows=None):
        b = lm_batch(s, 0, batch=L["batch"], seq=L["seq"],
                     vocab=L["data_vocab"], seed=0)
        return {k: v[:rows] for k, v in b.items()}

    def run(tr) -> dict:
        """DIST_TRAIN steps of ``tr``, each timed (gradient and optimizer
        step, synchronized; its peak memory without the checks' trees).
        On a mesh every rank gathers each step's gradients and params, and
        rank 0 keeps step 1's gradients and holds the params against the
        meshless optimizer (``apply_updates`` on full tensors) fed the
        run's own gradients from the same params."""
        on = tr.mesh is not None
        p = shd.full_tree(tr.params) if on else None
        if on and rank == 0:
            held["ref"] = opt_mod.tree_map(lambda x: x.detach(), p)
            held["ref_st"] = opt_mod.init_opt_state(held["ref"], ocfg)
        del p
        losses, ms, peaks, opt_gap = [], [], [], []
        _lib.reset_launches()
        for s in range(L["steps"]):
            b = tr.place_batch(batch(s))
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            loss, _, g = tr.value_and_grad(b)
            tr.apply_grads(g)
            torch.cuda.synchronize(dev)
            ms.append(1e3 * (time.perf_counter() - t))
            peaks.append(torch.cuda.max_memory_allocated(dev)
                         - _nbytes(held.values()))
            losses.append(float(shd.full_tree(loss)))
            if on:
                g, p = shd.full_tree(g), shd.full_tree(tr.params)
                if rank == 0:
                    held["ref"], held["ref_st"], _ = opt_mod.apply_updates(
                        held["ref"], g, held["ref_st"], ocfg)
                    opt_gap.append(_max_abs_diff(p, held["ref"]))
                    if s == 0:
                        held["grads0"] = g
                del p
            del loss, g
        held.pop("ref", None)
        held.pop("ref_st", None)
        params = shd.full_tree(tr.params)
        return dict(losses=losses, params=params if rank == 0 else None,
                    grads0=held.pop("grads0", None), opt_gap=opt_gap,
                    ms_per_step=ms, ms_per_step_median=float(np.median(ms)),
                    launches={k: v for k, v in _lib.LAUNCHES.items() if v},
                    max_memory_allocated_gb=max(peaks) / 1e9)

    def meshless(tr, fault: bool) -> dict:
        """Rank 0's meshless run: step 1's gradient at the start params
        (and, with ``fault``, the planted fault's: DIST_FAULT_ROWS rows,
        held to the split bound, which over half its leaves must fail),
        then ``run``."""
        _, _, g = tr.value_and_grad(tr.place_batch(batch(0)))
        out = {}
        if fault:
            _, _, gh = tr.value_and_grad(tr.place_batch(
                batch(0, DIST_FAULT_ROWS)))
            out["planted_fault"] = dict(
                rows=DIST_FAULT_ROWS, of=L["batch"],
                **_grad_gap(gh, g, DIST_SPLIT_GRAD_TOL))
            del gh
            if out["planted_fault"]["median_rel"] <= DIST_SPLIT_GRAD_TOL:
                fails.append(f"dist: the planted fault ({DIST_FAULT_ROWS} "
                             f"of {L['batch']} rows) passed the split "
                             f"gradient bound on half its leaves: "
                             f"{out['planted_fault']}")
        held["meshless_grads0"] = g
        out.update(run(tr))
        out["grads0"] = g
        held["meshless_params"] = out["params"]
        return out

    def profile_step(tr) -> dict:
        b = tr.place_batch(batch(L["steps"]))
        if rank == 0:
            return profile_forward(lambda: tr.train_step(b), 1)
        for _ in range(3):          # profile_forward's steps, in step
            tr.train_step(b)
        return {}

    def report(r) -> dict:
        return {k: v for k, v in r.items()
                if k not in ("params", "grads0", "opt_gap")}

    line: dict = dict(world=world, arch="smollm-360m", quant="w1a8",
                      compute_dtype=str(cfg.compute_dtype), remat=cfg.remat,
                      n_layers=cfg.n_layers, d_model=cfg.d_model,
                      batch=L["batch"], seq=L["seq"], steps=L["steps"],
                      failures=fails)
    ref = None
    if rank == 0:
        tr = Trainer(cfg, SINGLE, ocfg, TrainConfig(steps=L["steps"]),
                     device=dev)
        ref = meshless(tr, fault=True)
        line["planted_fault"] = ref.pop("planted_fault")
        ref["one_step_profile"] = profile_step(tr)
        del tr
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = init_device_mesh("cuda", (world, 1),
                            mesh_dim_names=("data", "model"))
    tr = Trainer(cfg, make_plan(shd.mesh_sizes(mesh)), ocfg,
                 TrainConfig(steps=L["steps"]), mesh=mesh)
    on_mesh = run(tr)
    check(not on_mesh["launches"],
          f"dist: training launched port kernels {on_mesh['launches']}")
    # the compressed all-reduce over the NCCL group, on this trainer's
    # gradients
    _, _, g = tr.value_and_grad(tr.place_batch(batch(L["steps"])))
    g = shd.full_tree(g)
    ef = {k: torch.zeros_like(v) for k, v in enumerate(tree_leaves(g))}
    g = dict(enumerate(tree_leaves(g)))
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    mean, ef_g = compressed_allreduce(g, ef, group=dist.group.WORLD)
    torch.cuda.synchronize(dev)
    comp_ms = 1e3 * (time.perf_counter() - t)
    loc, ef_l = compressed_allreduce(g, ef)
    same = all(torch.equal(mean[k], loc[k]) and torch.equal(ef_g[k], ef_l[k])
               for k in g)
    if world == 1:
        check(same, "dist: compressed_allreduce over the group differs "
              "from the local path at world 1")
    line["compressed_allreduce"] = dict(
        leaves=len(g), elements=sum(v.numel() for v in g.values()),
        ms=comp_ms, equal_to_local_path=same)
    del g, ef, mean, ef_g, loc, ef_l
    on_mesh["one_step_profile"] = profile_step(tr)
    del tr
    torch.cuda.empty_cache()
    if rank == 0:
        line["mesh"] = [world, 1]
        line["vs_meshless"] = _hold_trainer(
            f"dist ({world}, 1)", on_mesh, ref, world > 1, fails)
        line["meshless"], line["on_mesh"] = report(ref), report(on_mesh)
        line["dtensor_overhead_ms_per_step"] = (
            on_mesh["ms_per_step_median"] - ref["ms_per_step_median"])
    del on_mesh, ref
    held.clear()
    torch.cuda.empty_cache()
    if world >= 4:
        line["multi_card"] = _dist_multi_card(rank, world, cfg, ocfg,
                                              meshless, run, held, fails)
    else:
        line["multi_card"] = f"not run: {world} card" + (
            "s" if world != 1 else "")
    dist.destroy_process_group()
    return line


def _dist_multi_card(rank, world, cfg, ocfg, meshless, run, held: dict,
                     fails: list) -> dict:
    """Four or more cards: the trainer at ``(world / 2, 2)`` against a
    meshless run of the same plan (its padded query heads: SmolLM's 15
    pad to 16, so both start from one ``init_lm`` draw at that plan and
    the meshless trainer computes ``lm_loss`` under it), held as the
    ``(world, 1)`` run is, and the GPipe pipeline at S = 4 against the
    sequential stages on one card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import SINGLE, make_plan
    from repro_torch.distributed import pipeline as pipe
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainConfig, Trainer

    out = {}
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = init_device_mesh("cuda", (world // 2, 2),
                            mesh_dim_names=("data", "model"))
    plan = make_plan(shd.mesh_sizes(mesh))
    p0 = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, plan,
                   device=dev)
    tcfg = TrainConfig(steps=DIST_TRAIN["steps"])
    ref = None
    if rank == 0:
        ref = meshless(Trainer(cfg, SINGLE, ocfg, tcfg, device=dev,
                               params=p0, loss_fn=lambda p, b: T.lm_loss(
                                   p, b, cfg, plan)), fault=False)
        torch.cuda.empty_cache()
    dist.barrier()
    tp = run(Trainer(cfg, plan, ocfg, tcfg, mesh=mesh, params=p0))
    if rank == 0:
        out["trainer"] = dict(
            mesh=[world // 2, 2], padded_heads=plan.padded_heads(cfg.n_heads),
            **_hold_trainer(f"dist ({world // 2}, 2)", tp, ref, True, fails),
            ms_per_step_median=tp["ms_per_step_median"],
            max_memory_allocated_gb=tp["max_memory_allocated_gb"],
            meshless_ms_per_step_median=ref["ms_per_step_median"])
    del tp, ref, p0
    held.clear()
    torch.cuda.empty_cache()
    S, P = 4, DIST_PIPE
    pmesh = init_device_mesh("cuda", (S, world // S),
                             mesh_dim_names=("pipe", "data"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    ws = torch.randn((S, P["d"], P["d"]), generator=gen, device="cuda") \
        * P["d"] ** -0.5
    x = torch.randn((P["M"], P["mb"] * (world // S), P["d"]), generator=gen,
                    device="cuda")
    ws, x = ws.to(dev), x.to(dev)
    wd = distribute_tensor(ws, pmesh, [Shard(0), Replicate()]) \
        .requires_grad_()
    xd = distribute_tensor(x, pmesh, [Replicate(), Shard(1)])
    y = pipe.pipeline_apply(lambda w, h: torch.tanh(h @ w), wd, xd,
                            mesh=pmesh, n_microbatches=P["M"])
    yf = y.full_tensor()
    gw = torch.autograd.grad(yf.sum(), [wd])[0].full_tensor()
    if rank == 0:
        w0 = ws.detach().requires_grad_()
        h = x
        for s in range(S):
            h = torch.tanh(h @ w0[s])
        gref = torch.autograd.grad(h.sum(), [w0])[0]
        dy = float((yf - h).abs().max())
        dg = float((gw - gref).abs().max())
        tol = DIST_PIPE_TOL * max(float(h.abs().max()),
                                  float(gref.abs().max()))
        check(dy <= tol and dg <= tol,
              f"dist pipeline: |dy| {dy}, |dW| {dg} > {tol}")
        out["pipeline"] = dict(stages=S, mesh=[S, world // S], **P,
                               y_max_abs_diff=dy, dw_max_abs_diff=dg,
                               tol=tol)
    return out


def dist_phase(card: str) -> dict:
    """The distributed phase, one ``DIST`` line: (1) ``make_serve_mesh()``
    is None on one card; the data-parallel ``ServeEngine`` over two
    replicas on ``cuda:0`` (a test layout for one card) for svhn(64) W1A8
    (32 requests at ``max_batch=8``: each dispatch two 4-row replica
    forwards, bit-identical to the one-device engine at ``max_batch=4``
    with exactly twice a 4-row dispatch's launches, against one device's
    8-row dispatches within the alone-vs-batched tolerance; the two-replica
    and one-replica ``serve_window``s' requests/s side by side) and for
    SmolLM-360M W1A8 (two 2048-token prompts x 16 new tokens: each
    replica's tokens held to its prompt served alone, 32 ``attn_flash``
    launches a replica); (2) the trainer over NCCL in a child process a
    card (``dist_rank``); (3) with four or more cards the CNN engine over
    ``make_serve_mesh()`` too."""
    import dataclasses

    from repro_torch import api
    from repro_torch.configs import SINGLE, get_config
    from repro_torch.core import plan as P
    from repro_torch.core.quant import W1A8
    from repro_torch.kernels import _lib
    from repro_torch.launch.engine import CNNRunner, LMRunner, ServeEngine
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.serve import serve_once
    from repro_torch.models import transformer as T
    from repro_torch.models.cnn import init_cnn, svhn_cnn_spec
    from repro_torch.models.layers import prequantize_params

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    n_cards = torch.cuda.device_count()
    line: dict = dict(card=card, cards=n_cards)
    serve_mesh = make_serve_mesh()
    if n_cards == 1:
        check(serve_mesh is None,
              f"dist: make_serve_mesh() on one card is {serve_mesh}")
    line["make_serve_mesh"] = (None if serve_mesh is None
                               else [str(d) for d in serve_mesh])
    two = (dev, dev)
    try:
        # (1a) svhn(64) W1A8 over two replicas on one card
        rs = np.random.RandomState(11)
        images = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
                  for _ in range(DIST_SVHN_REQUESTS)]
        compiled = api.build(svhn_cnn_spec(), W1A8, params=init_cnn(
            torch.Generator(device=dev).manual_seed(0), svhn_cnn_spec()),
            img_hw=40).compile(target="cuda", batch_hints=(1, 8))
        runner = CNNRunner(compiled.plan)
        engines4 = [lp.engine for lp in P.layers_for_batch(compiled.plan, 4)]
        per4 = {k: 0 for k in _lib.LAUNCHES}
        per4.update(conv_implicit=engines4.count("implicit"),
                    fused_qgemm=engines4.count("fused"),
                    norm_act=len(engines4) - 1)
        one8 = ServeEngine(runner, max_batch=8)
        one4 = ServeEngine(runner, max_batch=4)
        dp = ServeEngine(runner, max_batch=8, mesh=two)
        for e in (one8, one4, dp):
            e.serve(images[:8])                 # warm-up, not counted
        torch.cuda.synchronize()
        _lib.reset_launches()
        one4.serve(images[:4])
        check(_lib.LAUNCHES == per4, f"dist: a 4-row dispatch launched "
              f"{_lib.LAUNCHES}, the plan's engines say {per4}")
        # ---- the data-parallel main path, counted
        d0 = dp.stats["dispatches"]
        _lib.reset_launches()
        got = np.stack([r.value for r in dp.serve(images)])
        launches = dict(_lib.LAUNCHES)
        # ----
        n_disp = dp.stats["dispatches"] - d0
        check(n_disp == DIST_SVHN_REQUESTS // 8,
              f"dist: {n_disp} dispatches for {DIST_SVHN_REQUESTS} requests")
        want = {k: 2 * n_disp * v for k, v in per4.items()}
        check(launches == want, f"dist: two-replica launches {launches} != "
              f"twice the 4-row dispatch's, {want}")
        four = np.stack([r.value for r in one4.serve(images)])
        eight = np.stack([r.value for r in one8.serve(images)])
        vs_four = _check_logits("dist svhn vs one device at the shard's size",
                                got, four, exact=True)
        vs_eight = _check_logits("dist svhn vs one device", got, eight)
        win_dp, vals = serve_window(dp, images)
        check(all(np.array_equal(v, got[i % len(images)])
                  for i, v in enumerate(vals)),
              "dist: the two-replica window differs from the request set")
        win_one, _ = serve_window(one8, images)
        line["svhn"] = dict(
            seconds=time.perf_counter() - t_phase,
            quant="w1a8", requests=DIST_SVHN_REQUESTS, max_batch=8,
            replicas=2, dispatches=n_disp,
            launches_per_dispatch={k: v // n_disp for k, v in
                                   launches.items() if v},
            launches_per_replica_dispatch={k: v for k, v in per4.items()
                                           if v},
            vs_one_device_at_shard_size=vs_four,
            vs_one_device=vs_eight,
            serving_window_two_replicas=win_dp,
            serving_window_one_device=win_one,
            requests_per_s_ratio=(win_dp["requests_per_s"]
                                  / win_one["requests_per_s"]))
        del one8, one4, dp, runner, compiled
        torch.cuda.empty_cache()

        # (1b) SmolLM-360M W1A8 over two replicas on one card
        t_lm = time.perf_counter()
        cfg = dataclasses.replace(get_config("smollm-360m"), quant=W1A8)
        params = prequantize_params(T.init_lm(
            torch.Generator(device=dev).manual_seed(2), cfg, SINGLE), cfg)
        rs = np.random.RandomState(3)
        prompts = [rs.randint(0, cfg.vocab, LM_PROMPT).astype(np.int32)
                   for _ in range(2)]
        lm_runner = LMRunner(params, cfg, new_tokens=LM_NEW)
        lm_dp = ServeEngine(lm_runner, max_batch=2, mesh=two)
        alone_eng = ServeEngine(lm_runner, max_batch=1)
        alone_eng.serve([prompts[0][:64]])       # warm-up, not counted
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        lm_res = lm_dp.serve(prompts)
        lm_s = time.perf_counter() - t0
        lm_launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
        check(lm_dp.stats["dispatches"] == 1,
              f"dist: {lm_dp.stats['dispatches']} LM dispatches")
        check(lm_launches == {"attn_flash": 2 * cfg.n_layers},
              f"dist: LM launches {lm_launches} != attn_flash "
              f"{cfg.n_layers} a replica")
        held = []
        for p, r in zip(prompts, lm_res):
            alone = alone_eng.serve([p])[0].value
            margins = np.zeros((1, LM_NEW))
            if not np.array_equal(r.value, alone):   # the oracle's margins
                m = []
                serve_once(params, cfg, SINGLE,
                           torch.from_numpy(p[None]).to(dev), LM_NEW,
                           "serve", margins=m)
                margins = torch.stack(m, dim=1).cpu().numpy()
            held.append(_hold_tokens("dist smollm replica vs alone",
                                     r.value, alone, margins))
            held[-1]["bit_identical"] = bool(np.array_equal(r.value, alone))
        line["smollm"] = dict(
            seconds=time.perf_counter() - t_lm, serve_seconds=lm_s,
            quant="w1a8", prompts=2, prompt_len=LM_PROMPT, new_tokens=LM_NEW,
            replicas=2,
            attn_flash_launches_per_replica=lm_launches.get("attn_flash", 0) // 2,
            vs_alone=held)
        del lm_dp, alone_eng, lm_runner, params
        torch.cuda.empty_cache()

        # (2) the trainer over NCCL, a child process a card
        t0 = time.perf_counter()
        line["train"] = _dist_children(n_cards)
        line["train"]["seconds"] = time.perf_counter() - t0
        line["train"]["card"] = card

        # (3) four or more cards: the CNN engine over make_serve_mesh()
        if n_cards >= 4:
            line["multi_card_serve"] = _dist_serve_mesh(serve_mesh, images)
        else:
            line["multi_card_serve"] = f"not run: {n_cards} card"
    except BaseException:
        print("DIST-PARTIAL", json.dumps(line, default=str), flush=True)
        raise
    line["seconds"] = time.perf_counter() - t_phase
    print("DIST", json.dumps(line), flush=True)
    return line


def _dist_children(n: int) -> dict:
    """Run ``dist_rank`` in ``n`` child processes (one a card, NCCL) and
    return rank 0's report; every child is stopped on the way out."""
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="dist_", dir=os.path.join(ROOT, "build"))
    out = os.path.join(d, "rank0.json")
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_CHILD, ROOT, str(r), str(n),
         os.path.join(d, "rendezvous"), out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        logs = [p.communicate(timeout=DIST_CHILD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    line = None
    if os.path.exists(out):
        with open(out) as f:
            line = json.load(f)
        check(not line["failures"], f"dist: {line['failures']} "
              f"(rank 0's report: {json.dumps(line)})")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"dist: rank {r} exited {p.returncode}")
    return line


def _dist_serve_mesh(mesh, images) -> dict:
    """The svhn(64) W1A8 engine over every card: each replica's rows equal
    one card's engine at the shard's size bit for bit."""
    from repro_torch import api
    from repro_torch.core.quant import W1A8
    from repro_torch.launch.engine import CNNRunner, ServeEngine
    from repro_torch.models.cnn import init_cnn, svhn_cnn_spec

    dev = torch.device("cuda", 0)
    compiled = api.build(svhn_cnn_spec(), W1A8, params=init_cnn(
        torch.Generator(device=dev).manual_seed(0), svhn_cnn_spec()),
        img_hw=40).compile(target="cuda", batch_hints=(1, 8))
    runner = CNNRunner(compiled.plan)
    n = len(mesh)
    dp = ServeEngine(runner, max_batch=8, mesh=mesh)
    shard = ServeEngine(runner, max_batch=max(8 // n, 1))
    got = np.stack([r.value for r in dp.serve(images)])
    ref = np.stack([r.value for r in shard.serve(images)])
    return dict(devices=n, vs_one_card_at_shard_size=_check_logits(
        "dist svhn over every card", got, ref, exact=True),
        serving_window=serve_window(dp, images)[0])


def _dry_cli(module: str, *args) -> subprocess.Popen:
    """``python -m MODULE ARGS`` from the repository root in a CPU-only
    interpreter (the dry run touches no device), started."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _dry_wait(tag: str, proc: subprocess.Popen, t0: float) -> tuple:
    try:
        log, _ = proc.communicate(timeout=DRY_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"DRYRUN {tag}: over {DRY_TIMEOUT_S} s")
    check(proc.returncode == 0, f"DRYRUN {tag}: exit {proc.returncode}: "
                                f"{log[-3000:]}")
    return log, time.perf_counter() - t0


def _dry_cell(path: str, tag: str, chips: int) -> dict:
    with open(path) as f:
        (res,) = json.load(f)
    check(res.get("ok") is True and set(res) == DRY_KEYS,
          f"DRYRUN {tag}: ok {res.get('ok')}, keys {sorted(res)}")
    check(res["chips"] == chips and res["flops"] > 0
          and sum(res["collectives"]["counts"].values()) > 0,
          f"DRYRUN {tag}: chips {res['chips']}, flops {res['flops']}, "
          f"collectives {res['collectives']['counts']}")
    return res


def counter_facts() -> dict:
    """What ``hlo_analysis.StepCounter`` and torch's ``FlopCounterMode``
    read, on this torch, for the cases the counter's design rests on: a
    Shard(0) x Shard(1) product of (128, 4096) @ (4096, 16384) and its
    weight gradient on a fake 16 x 16 mesh (the counter counts the local
    products: 4·8·4096·1024 if DTensor keeps the shards, more where it
    gathers one; FlopCounterMode counts the global op, and the op DTensor
    propagates shapes with on its first call),
    ``torch._int_mm`` (FlopCounterMode: 0) and RWKV-6's WKV scan (the
    read-out einsum counted, 2·B·S·H·K·V, the rest elementwise)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import rwkv6

    def both(fn):
        # FlopCounterMode first: before DTensor caches its shape
        # propagation, and before the counter registers torch._int_mm
        fc = FlopCounterMode(display=False)
        with fc:
            fn()
        with ha.StepCounter() as c:
            fn()
        return dict(step_counter=c.flops,
                    flop_counter_mode=float(fc.get_total_flops()))

    out = dict(torch=torch.__version__)
    a = torch.zeros((24, 64), dtype=torch.int8)
    b = torch.zeros((64, 32), dtype=torch.int8)
    out["int_mm"] = dict(both(lambda: torch._int_mm(a, b)),
                         expected=2.0 * 24 * 64 * 32)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        x = distribute_tensor(torch.empty(128, 4096, device="meta"), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(4096, 16384, device="meta"), mesh,
                              [Replicate(), Shard(1)]).requires_grad_()
        out["sharded_matmul_fwd_wgrad"] = dict(
            both(lambda: (x @ w).sum().backward()),
            local_if_kept=4.0 * 8 * 4096 * 1024,
            global_=4.0 * 128 * 4096 * 16384)
    B, S, H, K = 2, 8, 4, 16
    r = torch.rand(B, S, H, K)
    out["wkv_scan"] = dict(both(lambda: rwkv6._wkv_scan(
        r, r, r, r, torch.rand(H, K), torch.zeros(B, H, K, K))),
        readout_expected=2.0 * B * S * H * K * K)
    return out


def _live_cell(kind: str, batch: int, seq: int, prequant: bool,
               card: str) -> dict:
    """``launch.steps.build_cell`` of SmolLM-360M W1A8 (one device, no
    shardings): its step counted on meta, then run on the card on
    arguments drawn from DRY_SEED (params by ``init_lm``, prequantized for
    ``prequant``; tokens from numpy), DRY_RUNS times timed (synchronized),
    then once under the step counter, whose flops must equal meta's."""
    import dataclasses

    from repro_torch.configs import SINGLE, ShapeCell, get_config
    from repro_torch.core.quant import W1A8
    from repro_torch.kernels import _lib
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import prequantize_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import trainable

    cfg = dataclasses.replace(get_config("smollm-360m"), quant=W1A8)
    cell = ShapeCell(f"live_{kind}", kind, seq, batch)
    built = steps.build_cell(cfg, cell, SINGLE, None,
                             qmode="train" if kind == "train" else "serve",
                             prequant=prequant)
    t0 = time.perf_counter()
    with ha.StepCounter() as meta:
        built["fn"](*built["args"])
    meta_s = time.perf_counter() - t0
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(DRY_SEED),
                       cfg, SINGLE)
    if prequant:
        params = prequantize_params(params, cfg)
    toks = torch.from_numpy(np.random.RandomState(DRY_SEED).randint(
        0, cfg.vocab, (batch, seq)).astype(np.int32)).cuda()
    if kind == "train":
        params = trainable(params)
        args = (params, opt.init_opt_state(params, opt.OptConfig()),
                dict(tokens=toks, labels=torch.roll(toks, -1, dims=1)))
    else:
        args = (params, dict(tokens=toks))
    shapes = [(tuple(t.shape), t.dtype) for t in ha.tree_tensors(args)]
    check(shapes == [(tuple(t.shape), t.dtype)
                     for t in ha.tree_tensors(built["args"])],
          f"DRYRUN live {kind}: the card's arguments are not the cell's")
    want = {k: 0 for k in _lib.LAUNCHES}
    if kind == "prefill":
        want["attn_flash"] = cfg.n_blocks_of("attn")
    ms = []
    for _ in range(DRY_RUNS):
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = built["fn"](*args)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        check(dict(_lib.LAUNCHES) == want, f"DRYRUN live {kind}: launches "
              f"{dict(_lib.LAUNCHES)} != {want}")
        if kind == "train":
            check(bool(torch.isfinite(out[2]["loss"])),
                  f"DRYRUN live train: loss {out[2]['loss']}")
        else:
            check(tuple(out[0].shape) == (batch, cfg.padded_vocab)
                  and bool(torch.isfinite(out[0]).all()),
                  f"DRYRUN live prefill: logits {tuple(out[0].shape)}")
        del out
    with ha.StepCounter() as on_card:
        built["fn"](*args)
        torch.cuda.synchronize()
    check(on_card.flops == meta.flops, f"DRYRUN live {kind}: the card "
          f"counts {on_card.flops} flops, meta {meta.flops}")
    check(on_card.kernel_flops == meta.kernel_flops,
          f"DRYRUN live {kind}: kernel flops {on_card.kernel_flops} vs "
          f"{meta.kernel_flops}")
    med = sorted(ms)[len(ms) // 2]
    rl = ha.Roofline(hlo_flops=on_card.flops,
                     hlo_bytes=on_card.bytes_accessed, collective_bytes=0.0,
                     chips=1, model_flops=ha.model_flops_estimate(cfg, cell))
    del args, params
    torch.cuda.empty_cache()
    return dict(kind=kind, batch=batch, seq=seq, prequant=prequant,
                card=card, ms=ms, median_ms=med, flops=on_card.flops,
                meta_flops=meta.flops, kernel_flops=on_card.kernel_flops,
                meta_count_s=meta_s, launches={k: v for k, v in want.items()
                                               if v},
                roofline=rl.to_dict(), measured_s=med / 1e3,
                roofline_bound_over_measured=rl.bound_s / (med / 1e3),
                model_flops_share_of_bf16_peak=rl.model_flops / (
                    med / 1e3 * ha.PEAK_FLOPS_BF16))


def dryrun_phase(card: str) -> dict:
    """The dry-run tooling: build_cell's DRY_LIVE cells on the card
    (``_live_cell``, alone on the host), then DRY_CELLS through ``python
    -m repro_torch.launch.dryrun`` and the sweep over DRY_SWEEP (twice,
    the second skipping the cell), each in a CPU-only interpreter, the
    cells and the sweep's first run started at once.  One ``DRYRUN``
    line."""
    import shutil

    t_phase = time.perf_counter()
    live = [_live_cell(kind, b, s, pq, card) for kind, b, s, pq in DRY_LIVE]
    for r in live:
        print(f"DRYRUN live {r['kind']}: {r['median_ms']:.1f} ms (runs "
              f"{', '.join(f'{m:.1f}' for m in r['ms'])}), flops "
              f"{r['flops']:.4e} = meta's, model flops share of the bf16 "
              f"peak {r['model_flops_share_of_bf16_peak']:.4%} ({card})",
              flush=True)
    out_dir = os.path.join(ROOT, "build", "dryrun")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    sweep_dir = os.path.join(out_dir, "sweep")
    sweep_args = ("--only", DRY_SWEEP, "--out", sweep_dir,
                  "--timeout", str(DRY_TIMEOUT_S))
    t0 = time.perf_counter()
    procs = {}
    for arch, shape, extra in DRY_CELLS:
        path = os.path.join(out_dir, f"{arch}__{shape}.json")
        procs[arch, shape] = (path, extra, _dry_cli(
            "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
            *extra, "--out", path))
    sweep1 = _dry_cli("repro_torch.launch.sweep", *sweep_args)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    facts = subprocess.Popen([sys.executable, "-c", DRY_FACTS, ROOT],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    cells = {}
    for (arch, shape), (path, extra, proc) in procs.items():
        _, secs = _dry_wait(f"{arch} {shape}", proc, t0)
        res = _dry_cell(path, f"{arch} {shape}",
                        512 if "--multi-pod" in extra else 256)
        cells[f"{arch}:{shape}"] = dict(
            mesh=res["mesh"], chips=res["chips"], lower_s=res["lower_s"],
            process_s=secs, flops=res["flops"],
            bytes_accessed=res["bytes_accessed"], memory=res["memory"],
            collectives=res["collectives"]["counts"],
            collective_bytes=res["collectives"]["total_bytes"],
            roofline=res["roofline"])
    log1, s1 = _dry_wait("sweep (first run)", sweep1, t0)
    t1 = time.perf_counter()
    log2, s2 = _dry_wait("sweep (second run)",
                         _dry_cli("repro_torch.launch.sweep", *sweep_args),
                         t1)
    arch, shape = DRY_SWEEP.split(":")
    started = f"[sweep] {arch} x {shape} (16x16) ..."
    check(started in log1 and "complete: 1/1 OK" in log1,
          f"DRYRUN sweep: the first run did not run the cell: {log1[-800:]}")
    check(started not in log2 and "complete: 1/1 OK" in log2,
          f"DRYRUN sweep: the second run did not skip the cell: "
          f"{log2[-800:]}")
    res = _dry_cell(os.path.join(sweep_dir, f"{arch}__{shape}__16x16.json"),
                    "sweep", 256)
    cells[f"sweep {DRY_SWEEP}"] = dict(
        flops=res["flops"], collectives=res["collectives"]["counts"],
        first_run_s=s1, second_run_s=s2, second_run_skipped=True)
    log, _ = _dry_wait("counter facts", facts, t0)
    facts = json.loads(log.strip().splitlines()[-1])
    check(facts["int_mm"]["step_counter"] == facts["int_mm"]["expected"]
          and facts["wkv_scan"]["step_counter"]
          == facts["wkv_scan"]["readout_expected"],
          f"DRYRUN counter facts: {facts}")
    report = dict(card=card, cells=cells, live=live, counter_facts=facts,
                  seconds=time.perf_counter() - t_phase)
    print("DRYRUN", json.dumps(report), flush=True)
    return report


def bucket_step_profile(params, cfg, layers, batch: int, prompt_len: int,
                        new: int) -> dict:
    """One bucket decode step (``batch`` rows at position ``prompt_len``,
    attention over the full cache) under the profiler.  Each step rewrites
    the same cache slot, so the repeats do the same work."""
    from repro_torch.configs import SINGLE
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    cache = T.init_cache(cfg, SINGLE, batch, prompt_len + new, device=dev)
    if "attn" in cache:
        cache["attn"]["pos"][:, :, :prompt_len] = torch.arange(
            prompt_len, dtype=torch.int32, device=dev)
    tok = torch.ones((batch, 1), dtype=torch.int32, device=dev)
    prof = profile_forward(lambda: T.decode_step(
        params, cache, tok, prompt_len, cfg, SINGLE, layers=layers), 3)
    del cache
    return prof


def lm_profiles(params, cfg, layers, cont_engine) -> dict:
    """One decode step of each LM engine under the profiler: the bucket
    engine's (``bucket_step_profile`` at batch LM_BATCH, position
    LM_PROMPT) and the continuous engine's (CONT_SLOTS slots, each past a
    prompt of half the longest, 128 tokens).  Each step rewrites the same
    cache slot, so the repeats do the same work."""
    out = {"bucket_decode_step": bucket_step_profile(
        params, cfg, layers, LM_BATCH, LM_PROMPT, LM_NEW)}
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
                "quantize_pack", "bitgemm_packed", "int8_matmul", "norm_act")


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


def kernels_line(summary: dict, launches: dict, fam: dict | None = None,
                 train: dict | None = None) -> dict:
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
        "norm_act": ("src/repro_torch/csrc/norm_act.cu",
                     "none (src/repro/models/cnn.py _norm_act is jnp code)",
                     "one W1A4 launch at each hidden-layer shape of the "
                     "benchmark's svhn net (width 20) at batch 1024"),
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
        if name == NORM_NAME:
            entry["launches_per_dispatch"] = rows[0]["launches_per_dispatch"]
            entry["share_of_bound_by_shape"] = [r["share_of_bound"]
                                                for r in timed]
        if (name in ATTN_MAX_DEVICE_OPS or name in CNN_MAX_DEVICE_OPS
                or name in BIT_MAX_DEVICE_OPS or name == NORM_NAME):
            entry["device_ops_per_call"] = max(r["device_ops_per_call"]
                                               for r in rows
                                               if "device_ops_per_call" in r)
        if train is not None:
            # the train phase's handoff: the trained svhn CNN served once
            entry["launches_train_handoff"] = train.get(name, 0)
        if fam is not None and name in ATTN_MAX_DEVICE_OPS:
            entry["launches_families"] = {
                a["arch"]: n for a in fam["archs"]
                for n in [a["launches"].get(name, 0) + a.get(
                    "continuous", {}).get("launches", {}).get(name, 0)]
                if n}
        entry["shapes"] = [
            {k: r[k] for k in ("model", "layer", "case", "main_path", "path",
                               "shape",
                               "a_bits", "form", "ms", "plain_ms",
                               "copy_ms", "bound_ms", "bound_by",
                               "popc_floor_ms",
                               "library_ms", "library_call",
                               "device_ops_per_call") if k in r}
            for r in rows if "ms" in r]
        out.append(entry)
    return {"kernels": out}


# the phases after the kernels', in the order a whole run takes them, each
# with its line in the log; --phase NAME runs BUILD, the phases NAME reads
# (PHASE_NEEDS) and NAME
PHASES = (("cnn", "CNN MAIN PATH"), ("bitplane", "FAITHFUL/INT8 MAIN PATH"),
          ("spec", "SPEC PHASE"), ("lm", "LM MAIN PATH"), ("resilience", "RESILIENCE PHASE"),
          ("plan", "PLAN PHASE"), ("analysis", "ANALYSIS PHASE"),
          ("families", "FAMILIES PHASE"), ("modalities", "MODALITIES PHASE"),
          ("fleet", "FLEET PHASE"), ("train", "TRAIN PHASE"),
          ("dist", "DIST PHASE"), ("dryrun", "DRYRUN PHASE"))
PHASE_NEEDS = {"plan": ("lm",), "analysis": ("lm", "plan")}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases")
    ap.add_argument("--phase", choices=[n for n, _ in PHASES],
                    help="run BUILD and this phase alone (and the phases "
                         "it reads)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print("CARD", card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.kernels import _lib
    from repro_torch.launch.trace import TRACER

    t0 = time.perf_counter()
    _lib.build_all()
    builds = TRACER.records(t0).where("kernels.build")
    print(f"BUILD {time.perf_counter() - t0:.1f} s "
          + json.dumps({_lib.SOURCES[i]: round(b - a, 1) for i, a, b
                        in zip(builds.ident, builds.t0, builds.t1)}))
    if args.phase is None:
        flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        t0 = time.perf_counter()
        summary = kernel_phase(flush)
        t1 = time.perf_counter()
        summary.update(bitplane_kernel_phase(flush))
        t2 = time.perf_counter()
        summary.update(lm_kernel_phase(flush))
        t3 = time.perf_counter()
        summary.update(norm_act_kernel_phase(flush))
        print(f"KERNEL PHASES cnn {t1 - t0:.1f} s, bit-plane {t2 - t1:.1f} s, "
              f"lm {t3 - t2:.1f} s, norm {time.perf_counter() - t3:.1f} s",
              flush=True)
        del flush
        if args.kernels_only:
            print("KERNELS-ONLY done", flush=True)
            return 0
    global PROOFS
    PROOFS = _Proofs().install()
    done: dict = {}
    run = {"cnn": lambda: main_path(card),
           "bitplane": lambda: bitplane_main_path(card),
           "spec": lambda: spec_phase(card),
           "lm": lambda: lm_main_path(card),
           "resilience": lambda: resilience_phase(card),
           "plan": lambda: plan_phase(card, done["lm"]),
           "analysis": lambda: analysis_phase(card),
           "families": lambda: families_phase(card),
           "modalities": lambda: modalities_phase(card),
           "fleet": lambda: fleet_phase(card),
           "train": lambda: train_phase(card),
           "dist": lambda: dist_phase(card),
           "dryrun": lambda: dryrun_phase(card)}
    todo = ([n for n, _ in PHASES] if args.phase is None
            else [*PHASE_NEEDS.get(args.phase, ()), args.phase])
    for name, label in PHASES:
        if name in todo:
            t0 = time.perf_counter()
            done[name] = run[name]()
            print(f"{label} {time.perf_counter() - t0:.1f} s", flush=True)
    if args.phase is None:
        launches = {k: done["cnn"]["launches"][k]
                    for k in ("fused_qgemm", "conv_implicit", NORM_NAME)}
        launches.update({k: done["bitplane"]["launches"][k]
                         for k in ("quantize_pack", "bitgemm_packed",
                                   "int8_matmul")})
        launches.update({k: done["lm"]["launches"][k]
                         for k in ("attn_flash", "attn_paged")})
        print(json.dumps(kernels_line(summary, launches, dict(
            archs=done["families"]["archs"] + done["modalities"]["archs"]),
            done["train"]["handoff"]["launches"])))
    print(f"TOTAL {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

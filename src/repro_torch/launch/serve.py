"""LM serving entry point: batched prefill + greedy decode over a KV cache (port
of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --quant w1a8 --batch 2 --prompt-len 16 --new-tokens 16 [--no-smoke]

Serves the token-input archs (dense, MoE, RWKV-6, RecurrentGemma, and
the VLM on text alone, as the reference's CLI does); hubert-xlarge takes
frame features, which only ``models.transformer.prefill(frame_feats=)``
takes, so its prefill raises a ``ValueError`` naming that call (the
reference's CLI fails on it too).  Runs on
the card (``--device cuda``, the default) unless asked for the CPU.  A
quantized ``--quant`` serves prequantized weights (``engine=serve``);
``--quant w32a32`` or no ``--quant`` serves the float weights through
the train-mode ``qdense`` (``engine=train``), as the reference does.  Decode is a Python loop over tokens (the reference's one-trace
``lax.scan``): each step runs the model once on the cache, which it
updates in place.  ``--throughput`` drives the bucket engine
(``launch/engine.ServeEngine`` + ``LMRunner``), ``--continuous`` the
paged continuous-batching engine (``ContinuousLMEngine``), and
``--chaos-mtbf STEPS`` the resilient engine (``repro_torch.resilience``)
under a seeded fault schedule with K-step decode epoch checkpoints
(``--epoch-steps``, ``--checkpoint-dir``), checked against a fault-free
run of the same engine.  ``--plan-cache PATH`` compiles the LM's execution
plan through the facade (``api.build(cfg, params=...).compile(...)``) and
saves it, or reloads it when ``PATH.json`` exists (no requantization, no
measurement); ``--autotune`` times the signed engines per GEMM shape on
the device while compiling.  Every mode then serves through the plan.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import SINGLE, get_config
from repro_torch.core.quant import PAPER_CONFIGS
from repro_torch.models import transformer as T

# cache tensors with a sequence axis (transformer.init_cache's layout:
# (layers, batch, slots, ...)), identified by key, never by size: the
# recurrent state (rec h/conv, rwkv tm_x/cm_x/s) has no sequence axis
CACHE_SEQ_AXIS = {"k": 2, "v": 2, "pos": 2}


def grow_cache(cache, prompt_len: int, slots: int):
    """Grow a prefill cache to the decode horizon: new k/v slots are zero,
    new ``pos`` entries -1 (empty).  Entries without ``pos`` (recurrent
    state) pass through untouched, whatever their sizes."""
    out = {}
    for kind, entry in cache.items():
        if not (isinstance(entry, dict) and "pos" in entry):
            out[kind] = entry
            continue
        widened = dict(entry)
        for key, axis in CACHE_SEQ_AXIS.items():
            t = entry[key]
            grow = slots - t.shape[axis]
            if grow <= 0:
                continue
            pad = list(t.shape)
            pad[axis] = grow
            widened[key] = torch.cat(
                [t, torch.full(pad, -1 if key == "pos" else 0, dtype=t.dtype,
                               device=t.device)], dim=axis)
        out[kind] = widened
    return out


def greedy_token(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Greedy next token over the real vocab only (the padded unembed tail
    is never served): (B, S, Vp) -> (B, 1) int32."""
    return torch.argmax(logits[:, -1:, :vocab], dim=-1).to(torch.int32)


def top2_margin(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gap between the two largest real-vocab logits of the last position,
    (B,): how far the greedy pick is from a tie."""
    top = torch.topk(logits[:, -1, :vocab], 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def make_prefill(params, cfg, plan, qmode: str, reference: bool = False):
    """prefill(tokens (B, S_p)) -> (logits, cache)."""
    layers = T.unstack_layers(params, cfg)

    def prefill(toks):
        return T.prefill(params, cfg, plan, tokens=toks, qmode=qmode,
                         layers=layers, reference=reference)

    return prefill


def make_decode_step(params, cfg, plan, qmode: str, reference: bool = False):
    """step(cache, tok (B, 1), pos) -> (cache, next tok (B, 1), logits):
    one ``decode_step`` and the real-vocab argmax."""
    layers = T.unstack_layers(params, cfg)

    def step(cache, tok, pos: int):
        logits, cache = T.decode_step(params, cache, tok, pos, cfg, plan,
                                      qmode=qmode, layers=layers,
                                      reference=reference)
        return cache, greedy_token(logits, cfg.vocab), logits

    return step


def make_generate(params, cfg, plan, qmode: str, prompt_len: int,
                  new_tokens: int, reference: bool = False):
    """gen(grown cache, first token (B, 1), margins=None) -> (B, S_d): a
    Python loop of ``new_tokens - 1`` decode steps.  A ``margins`` list
    receives each step's :func:`top2_margin`."""
    step = make_decode_step(params, cfg, plan, qmode, reference)

    def gen(cache, first_tok, margins=None):
        toks, tok = [first_tok], first_tok
        for i in range(new_tokens - 1):
            cache, tok, logits = step(cache, tok, prompt_len + i)
            toks.append(tok)
            if margins is not None:
                margins.append(top2_margin(logits, cfg.vocab))
        return torch.cat(toks, dim=1)

    return gen


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(prompts: torch.Tensor, new_tokens: int, vocab: int, prefill_fn,
             generate_fn, margins=None) -> torch.Tensor:
    """prefill -> grow -> first greedy token -> decode loop: (B, S_d)
    tokens, not waited for.  ``margins`` (a list) receives the top-2
    logit margin of every greedy pick, as (B,) tensors in order."""
    s_p = prompts.shape[1]
    logits, cache = prefill_fn(prompts)
    cache = grow_cache(cache, s_p, s_p + new_tokens)
    if margins is not None:
        margins.append(top2_margin(logits, vocab))
    return generate_fn(cache, greedy_token(logits, vocab), margins=margins)


def serve_once(params, cfg, plan, prompts: torch.Tensor, new_tokens: int,
               qmode: str, prefill_fn=None, generate_fn=None,
               reference: bool = False, margins=None):
    """One batched request (:func:`generate`), waited for.  Returns
    (tokens (B, S_d), wall seconds)."""
    prefill_fn = prefill_fn or make_prefill(params, cfg, plan, qmode,
                                            reference)
    generate_fn = generate_fn or make_generate(
        params, cfg, plan, qmode, prompts.shape[1], new_tokens, reference)
    t0 = time.perf_counter()
    gen = generate(prompts, new_tokens, cfg.vocab, prefill_fn, generate_fn,
                   margins)
    _sync(gen.device)
    return gen, time.perf_counter() - t0


def _prompts(n: int, length: int, vocab: int) -> list:
    return [np.random.RandomState(i).randint(0, vocab, size=(length,))
            .astype(np.int32) for i in range(n)]


def run_throughput(params, cfg, qmode: str, args, model_plan=None) -> None:
    """``--throughput``: the bucket engine, sequential (max_batch=1) vs
    batched, closed loop, then an offered-rate sweep."""
    import json

    from repro_torch.launch.engine import (LMRunner, ServeEngine,
                                           run_offered_load, warm_engine)

    prompts = _prompts(args.requests, args.prompt_len, cfg.vocab)

    def mk(max_batch):
        return ServeEngine(
            LMRunner(params, cfg, new_tokens=args.new_tokens, qmode=qmode,
                     model_plan=model_plan),
            max_batch=max_batch,
            flush_deadline_s=args.flush_deadline_ms / 1e3)

    seq = run_offered_load(warm_engine(mk(1), prompts), prompts, None)
    eng = warm_engine(mk(args.batch), prompts)
    bat = run_offered_load(eng, prompts, None)
    print(f"arch={cfg.name} device={args.device} requests={args.requests} "
          f"prompt_len={args.prompt_len} new_tokens={args.new_tokens}")
    print(f"sequential: {seq['achieved_rps']:.1f} req/s "
          f"p50={seq['p50_ms']}ms p99={seq['p99_ms']}ms")
    print(f"batch={args.batch}: {bat['achieved_rps']:.1f} req/s "
          f"p50={bat['p50_ms']}ms p99={bat['p99_ms']}ms "
          f"({bat['achieved_rps'] / max(seq['achieved_rps'], 1e-9):.2f}x)")
    for mult in (0.5, 1.0, 2.0, 4.0):
        row = run_offered_load(eng, prompts,
                               rate_rps=mult * seq["achieved_rps"])
        print(f"offered {row['offered_rps']:>8} req/s: {json.dumps(row)}")


def run_continuous(params, cfg, qmode: str, args, model_plan=None) -> None:
    """``--continuous``: the paged continuous-batching engine against the
    bucket engine at the same capacity, on a mixed prompt/horizon set."""
    import json

    from repro_torch.launch.engine import (ContinuousLMEngine, LMRunner,
                                           ServeEngine, run_offered_load,
                                           warm_engine)

    rng = np.random.RandomState(0)
    gens = (max(args.new_tokens // 2, 1), args.new_tokens,
            args.new_tokens * 2)
    payloads = [
        (rng.randint(0, cfg.vocab,
                     size=(int(rng.choice((args.prompt_len // 2 or 1,
                                           args.prompt_len),)),))
         .astype(np.int32), int(rng.choice(gens)))
        for _ in range(args.requests)]
    bucket = ServeEngine(
        LMRunner(params, cfg, new_tokens=args.new_tokens, qmode=qmode,
                 model_plan=model_plan),
        max_batch=args.batch, flush_deadline_s=args.flush_deadline_ms / 1e3)
    cont = ContinuousLMEngine(
        params, cfg, num_slots=args.slots, page_size=args.page_size,
        num_pages=args.pages, new_tokens=args.new_tokens,
        max_seq=args.prompt_len + 2 * args.new_tokens, qmode=qmode,
        model_plan=model_plan)
    rb = run_offered_load(warm_engine(bucket, payloads), payloads, None)
    rc = run_offered_load(warm_engine(cont, payloads), payloads, None)
    print(f"arch={cfg.name} device={args.device} requests={args.requests} "
          f"mixed prompts/horizons slots={args.slots} "
          f"pages={args.pages}x{args.page_size}")
    print(f"bucket    : {json.dumps(rb)}")
    print(f"continuous: {json.dumps(rc)} "
          f"({rc['achieved_rps'] / max(rb['achieved_rps'], 1e-9):.2f}x)")
    print(f"programs={sorted(cont.program_shapes)} pool={cont.pool.stats()}")


def run_chaos(params, cfg, qmode: str, args, model_plan=None) -> None:
    """``--chaos-mtbf``: the resilient engine under a seeded exponential
    fault schedule with decode epoch checkpoints; every completed request
    is held against a fault-free run of the same engine configuration."""
    import tempfile

    from repro_torch.resilience import (EpochLMRunner, FaultPlan,
                                        ResilientServeEngine)

    prompts = _prompts(args.requests, args.prompt_len, cfg.vocab)

    def mk(ckdir, faults=None):
        runner = EpochLMRunner(params, cfg, new_tokens=args.new_tokens,
                               epoch_steps=args.epoch_steps, qmode=qmode,
                               model_plan=model_plan)
        return ResilientServeEngine(
            runner, fault_plan=faults, checkpoint_dir=ckdir,
            max_batch=args.batch,
            flush_deadline_s=args.flush_deadline_ms / 1e3, max_retries=1000)

    ref = [r.value for r in mk(None).serve(list(prompts))]
    with tempfile.TemporaryDirectory(prefix="chaos_ckpt_") as tmp:
        eng = mk(args.checkpoint_dir or tmp,
                 FaultPlan(args.chaos_mtbf, seed=args.chaos_seed))
        t0 = time.perf_counter()
        res = eng.serve(list(prompts))
        wall = time.perf_counter() - t0
    identical = len(res) == len(ref) and all(
        np.array_equal(r.value, v) for r, v in zip(res, ref))
    s = eng.stats
    print(f"arch={cfg.name} device={args.device} chaos: "
          f"mtbf={args.chaos_mtbf} steps (seed {args.chaos_seed}), "
          f"K={args.epoch_steps}, requests={len(prompts)}")
    print(f"completed {len(res)}/{len(prompts)} in {wall:.2f}s, "
          f"bit-identical to fault-free: {identical}")
    print(f"faults={s['faults']} (power={s['power_losses']} "
          f"drop={s['device_drops']} slow={s['slow_dispatches']} "
          f"staging={s['staging_retries']}) retries={s['retries']} "
          f"dead={s['dead_lettered']}")
    print(f"prefills={s['prefills']} resumes={s['resumes']} "
          f"epochs={s['epochs']} commits={s['commits']} "
          f"commit_s={s['commit_s']:.4f} "
          f"executed_steps={s['executed_steps']} "
          f"useful_steps={s['useful_steps']} "
          f"wasted_steps={s['wasted_steps']:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card by default; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--quant", default=None, choices=list(PAPER_CONFIGS))
    ap.add_argument("--plan-cache", default=None, metavar="PATH",
                    help="compile-once execution plan: reload PATH.json if "
                         "it exists (no requantization, no autotune), else "
                         "compile the plan and save it there")
    ap.add_argument("--autotune", action="store_true",
                    help="time the signed engines per GEMM shape on the "
                         "device while compiling the plan")
    ap.add_argument("--throughput", action="store_true")
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=64)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--flush-deadline-ms", type=float, default=2.0)
    ap.add_argument("--chaos-mtbf", type=float, default=None, metavar="STEPS",
                    help="fault-injected serving: mean decode steps between "
                         "faults (exponential schedule); runs the resilient "
                         "engine and holds it against a fault-free run")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="--chaos-mtbf: fault schedule seed")
    ap.add_argument("--epoch-steps", type=int, default=4,
                    help="--chaos-mtbf: decode checkpoint period K (the "
                         "paper's NV write period P, in decode steps)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="--chaos-mtbf: decode epoch checkpoint directory "
                         "(default: a temporary directory)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "false (pass --device cpu for the plain versions)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.quant:
        cfg = dataclasses.replace(cfg, quant=PAPER_CONFIGS[args.quant])
    qmode = "serve" if args.quant and args.quant != "w32a32" else "train"
    if qmode == "train" and (args.plan_cache or args.autotune):
        ap.error("--plan-cache/--autotune compile a plan of the quantized "
                 "serve path: pass --quant (not w32a32)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    from repro_torch.models.layers import prequantize_params

    model_plan = None
    params = T.init_lm(gen, cfg, SINGLE, device)
    if args.plan_cache or args.autotune:
        from repro_torch import api

        compiled = api.build(cfg, params=params).compile(
            batch_hints=(args.batch,), prompt_len=args.prompt_len,
            autotune=args.autotune, cache=args.plan_cache)
        model_plan = compiled.plan
        if compiled.reloaded:
            print(f"plan: reloaded {args.plan_cache} in "
                  f"{compiled.compile_s * 1e3:.1f}ms (requantization "
                  f"+ autotune skipped)")
        else:
            print(f"plan: compiled{' +autotune' if args.autotune else ''} in "
                  f"{compiled.compile_s * 1e3:.1f}ms -> {compiled.cache_path}")
        params = model_plan.params
    elif qmode == "serve":
        params = prequantize_params(params, cfg)
    # with a plan, every dispatch of the run is a lookup in its tables
    with (model_plan.activate() if model_plan is not None
          else contextlib.nullcontext()):
        return _run(params, cfg, qmode, args, device, model_plan)


def _run(params, cfg, qmode: str, args, device, model_plan) -> None:
    if args.chaos_mtbf is not None:
        return run_chaos(params, cfg, qmode, args, model_plan)
    if args.continuous:
        return run_continuous(params, cfg, qmode, args, model_plan)
    if args.throughput:
        return run_throughput(params, cfg, qmode, args, model_plan)
    B, S_p, S_d = args.batch, args.prompt_len, args.new_tokens
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(B, S_p)).astype(np.int32)).to(device)
    prefill_fn = make_prefill(params, cfg, SINGLE, qmode)
    generate_fn = make_generate(params, cfg, SINGLE, qmode, S_p, S_d)
    out, dt_cold = serve_once(params, cfg, SINGLE, prompts, S_d, qmode,
                              prefill_fn, generate_fn)
    _, dt_warm = serve_once(params, cfg, SINGLE, prompts, S_d, qmode,
                            prefill_fn, generate_fn)
    print(f"arch={cfg.name} quant={args.quant or 'fp'} device={device} "
          f"engine={qmode}")
    print(f"generated {B}x{S_d} tokens: cold {dt_cold:.2f}s "
          f"({B * S_d / dt_cold:.1f} tok/s incl. kernel builds), "
          f"warm {dt_warm * 1e3:.1f}ms ({B * S_d / dt_warm:.1f} tok/s)")
    for b in range(min(B, 2)):
        print(f"  sample[{b}]: {out[b][:12].tolist()}")


if __name__ == "__main__":
    main()

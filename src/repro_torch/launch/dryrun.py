"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): run one step of
every (arch x input-shape) cell on the production meshes, without a
device, and report its memory, flops, bytes, collectives and roofline.

The reference lowers and compiles each cell for 512 XLA host devices.
Here a process of its own starts a ``fake`` process group of 256 (16 x
16) or 512 (2 x 16 x 16) ranks on a ``FakeStore`` (rank 0; collectives
return at once), builds the production mesh on it
(``launch.mesh.make_production_mesh``), places the cell's arguments as
meta DTensors (``launch.steps.build_cell``'s shardings) and runs the step
on them once under ``hlo_analysis.StepCounter``: DTensor plans every
redistribution and issues its collectives, and every op runs on rank 0's
meta shards.  By design this touches no device, as the reference's
host-device dry run touches no TPU: it is not a fallback, and it runs the
same on a machine with a card.  The kernels' wrappers take their plain
versions on meta tensors and count their work by formula
(``kernels._lib.counted``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b \\
      --shape train_4k [--multi-pod] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Each cell's JSON has the reference's keys:
  lower_s      seconds to place the arguments and run the step (the trace);
  compile_s    0.0: nothing is compiled;
  memory       argument_size_in_bytes / output_size_in_bytes: rank 0's
               shards of the arguments and of the outputs;
               temp_size_in_bytes / generated_code_size_in_bytes: None, as
               XLA's buffer assignment and generated code have no eager
               counterpart (an eager step frees each temporary when its
               last user is done, at an order the run decides);
  flops        per-device flops as ``StepCounter`` counts them (products,
               not elementwise ops);
  bytes_accessed  the unfused sum of every op's operand and result bytes
               per device: an upper count, where XLA's is its fused
               program's;
  collectives  ``StepCounter.comm_stats()``: per kind, counts and operand
               bytes per device;
  roofline     ``hlo_analysis.Roofline`` at the H100's peaks, its flops
               those counted plus the RWKV recurrence's part the counter
               does not see (``recurrence_flops_uncounted`` / chips).
Exit code 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

from repro_torch.configs import SHAPES, all_configs, get_config, make_plan
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh, mesh_shape_dict


@contextlib.contextmanager
def fake_world(ranks: int):
    """A ``fake`` process group of ``ranks`` ranks, this process rank 0,
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _place(args, shardings, mesh):
    """Each tensor argument as a meta DTensor in its placements (a train
    cell's float params keep requiring grad); other arguments as they
    are."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.train.trainer import trainable

    out = []
    for arg, sh in zip(args, shardings):
        if isinstance(arg, (dict, list, torch.Tensor)):
            placed = shd.distribute_tree(arg, sh, mesh)
            if isinstance(arg, dict) and any(
                    t.requires_grad for t in ha.tree_tensors(arg)):
                placed = trainable(placed)
            out.append(placed)
        else:
            out.append(arg)
    return tuple(out)


def _local_bytes(tree) -> int:
    return sum(ha.local_nbytes(t) for t in ha.tree_tensors(tree))


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             overrides: dict | None = None, verbose: bool = True,
             analysis: bool = False, infer_plan: bool = False,
             quant: str | None = None, prequant: bool = False) -> dict:
    """One cell on the 16 x 16 (or, ``multi_pod``, 2 x 16 x 16) fake mesh
    -> the reference's result dict.  ``analysis`` sets the reference's
    analysis toggles (``full_attn_analysis``, ``rglru_assoc``;
    ``scan_layers=False``), ``overrides`` any ``ArchConfig`` fields."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.layers import set_static_act_scale

    cfg = get_config(arch)
    if quant:
        from repro_torch.core.quant import PAPER_CONFIGS
        cfg = dataclasses.replace(cfg, quant=PAPER_CONFIGS[quant])
    if analysis:
        cfg = dataclasses.replace(cfg, scan_layers=False,
                                  full_attn_analysis=True, rglru_assoc=True)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape]
    chips = 512 if multi_pod else 256
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        plan = make_plan(mesh_shape_dict(mesh),
                         inference=infer_plan and cell.kind != "train")
        t0 = time.time()
        set_static_act_scale(cfg.act_scale)
        try:
            built = steps_mod.build_cell(
                cfg, cell, plan, mesh,
                qmode="serve" if (quant and cell.kind != "train") else "train",
                prequant=prequant)
            args = _place(built["args"], built["in_shardings"], mesh)
            with shd.on_mesh(), ha.StepCounter() as counter:
                out = built["fn"](*args)
        finally:
            set_static_act_scale(0.0)
        t_lower = time.time() - t0
        mem = dict(argument_size_in_bytes=_local_bytes(args),
                   output_size_in_bytes=_local_bytes(out),
                   temp_size_in_bytes=None,
                   generated_code_size_in_bytes=None)
    coll = counter.comm_stats()
    flops, byts = counter.flops, counter.bytes_accessed
    rec_corr = ha.recurrence_flops_uncounted(cfg, cell) / chips
    rl = ha.Roofline(
        hlo_flops=flops + rec_corr, hlo_bytes=byts,
        collective_bytes=float(coll["total_bytes"]), chips=chips,
        model_flops=ha.model_flops_estimate(cfg, cell))
    res = dict(
        arch=arch, shape=shape, mesh="2x16x16" if multi_pod else "16x16",
        chips=chips, ok=True, lower_s=round(t_lower, 1), compile_s=0.0,
        memory=mem, collectives=coll, roofline=rl.to_dict(),
        flops=flops, bytes_accessed=byts)
    if verbose:
        print(f"[dryrun] {arch} x {shape} on {res['mesh']}:")
        print(f"  memory: {mem}")
        print(f"  counted: flops={flops:.3e} bytes={byts:.3e}")
        print(f"  collectives: {coll['counts']} -> {coll['total_bytes']:.3e} B")
        r = res["roofline"]
        print(f"  roofline: compute={r['compute_s']:.4e}s "
              f"memory={r['memory_s']:.4e}s "
              f"collective={r['collective_s']:.4e}s dominant={r['dominant']} "
              f"useful={r['useful_flops_frac']:.2%} "
              f"frac={r['roofline_frac']:.2%}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--analysis", action="store_true")
    ap.add_argument("--infer-plan", action="store_true")
    ap.add_argument("--quant", default=None)
    ap.add_argument("--prequant", action="store_true")
    ap.add_argument("--set", default=None,
                    help="comma list of ArchConfig overrides key=val (bool/int)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch, cfg in all_configs().items():
            for cell in cfg.shapes():
                cells.append((arch, cell.name))
    elif args.arch and args.shape:
        cells.append((args.arch, args.shape))
    else:
        ap.error("--arch and --shape (or --all)")

    overrides = {}
    if args.set:
        for kv in args.set.split(","):
            k, v = kv.split("=")
            overrides[k] = (v == "1" if v in ("0", "1") else
                            int(v) if v.isdigit() else v)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    fails = 0
    for arch, shape in cells:
        for mp in meshes:
            try:
                results.append(run_cell(
                    arch, shape, multi_pod=mp, analysis=args.analysis,
                    infer_plan=args.infer_plan, quant=args.quant,
                    prequant=args.prequant, overrides=overrides or None))
            except Exception as e:  # repro-lint: disable=RL003 — a failure here is a bug: structured-recorded below and the run exits nonzero
                fails += 1
                traceback.print_exc()
                results.append(dict(arch=arch, shape=shape,
                                    mesh="2x16x16" if mp else "16x16",
                                    ok=False, error=str(e)[-2000:],
                                    error_type=type(e).__name__,
                                    traceback=traceback.format_exc()[-2000:]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"[dryrun] {len(results) - fails}/{len(results)} cells OK")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

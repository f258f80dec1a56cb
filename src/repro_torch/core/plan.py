"""Compile-once execution plans (port of ``repro/core/plan.py``).

:func:`compile_model` (CNNs) resolves every layer's engine at every batch
hint, annotates each layer with the compile target's roofline cost and
pre-quantizes the weights once; :func:`plan_forward` walks the resulting
:class:`ModelPlan`.  An explicit ``QuantConfig.engine`` (any of the
reference's dense engines) pins every quantized layer; the faithful
engine's weight planes are packed once, at compile or load.
:func:`compile_lm` (transformers) pre-quantizes every projection and
resolves one verdict per distinct (K, N) GEMM into the plan's dense table
and one per attention geometry into its attention table; the serving
engines consult both while the plan is active (:meth:`ModelPlan.activate`).
:func:`cnn_serve_layers` is the cached per-call plan of the legacy entry
point ``models.cnn.cnn_forward(mode="serve")``, which
:func:`execute_cnn_layers` runs on float or prequantized params.

Engines resolve three ways, recorded per layer as ``engine_source``:
``override`` (an explicit ``QuantConfig.engine``, checked feasible at
compile time), ``autotuned`` (the candidates timed on the device the
params live on, :func:`repro_torch.kernels.ops.autotune_engine`; the
measurements travel with the plan) or ``heuristic`` (the target's cost
model, never another plan's installed verdicts).

:func:`save_plan` / :func:`load_plan` write and read the reference's
on-disk layout (``<path>.json`` metadata + ``<path>.npz`` levels, the same
``PLAN_VERSION``): a restarted node reloads its plan and never
requantizes or measures.  ``ModelPlan.meta()`` carries the reference's
keys, so a plan's :meth:`~ModelPlan.fingerprint` hashes the same fields.

Both compile passes prove their plan before returning it
(:func:`repro_torch.analysis.prover.assert_plan_verified`, PV101-PV108
against the Hopper kernels' bounds), as the reference does;
``verify=False`` skips the proof.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.core import and_accum
from repro_torch.core.prequant import (is_fp_layer, is_prequantized,
                                       prequantize_cnn_params,
                                       prequantize_conv_weight)
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops
from repro_torch.launch.trace import TRACER

PLAN_VERSION = 1

# engines of the signed (affine-corrected) LM serve path: the fused and
# faithful epilogues implement the unsigned correction only
SIGNED_ENGINES = and_accum.SIGNED_ENGINES


class PlanError(ValueError):
    """A plan could not be compiled or executed; the message names the
    offending layer."""


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's compiled execution record.  ``engine`` is the verdict at
    the primary batch hint; ``engines`` the ``(batch_hint, engine)`` table."""

    index: int
    name: str
    op: str                 # "conv" | "dense" | "attn"
    role: str               # first | mid | last
    fp: bool                # full-precision layer (no bitwise engine)
    kh: int
    kw: int
    stride: int
    padding: str
    cin: int
    cout: int
    in_h: int
    in_w: int
    out_h: int
    out_w: int
    k: int                  # GEMM depth kh*kw*cin
    a_bits: int
    w_bits: int
    engine: str             # "fp" for fp layers
    engine_source: str      # fp | override | autotuned | heuristic
    engines: tuple          # ((batch_hint, engine), ...)
    pool: bool = False
    fc: bool = False
    # per-image (energy_pj, cycles, bytes_moved) roofline estimate on the
    # compile target (api.targets) — annotation only, never read by
    # execution; part of the fingerprint
    cost: tuple = ()
    # attention realization of an "attn" row (LM plans); "" for convs
    attn_engine: str = ""

    def engine_at(self, batch: int) -> str:
        """Exact hint, else the largest hint not above ``batch``, else the
        smallest hint."""
        table = dict(self.engines)
        if batch in table:
            return table[batch]
        below = [b for b, _ in self.engines if b <= batch]
        return table[max(below)] if below else table[min(table)]


@dataclasses.dataclass
class ModelPlan:
    """A compiled, serializable execution plan for one model on one
    compute target (``backend``: the target's name, ``cuda``)."""

    kind: str                       # "cnn" | "lm"
    model: str
    backend: str
    quant: QuantConfig
    batch_hints: tuple
    layers: tuple                   # tuple[LayerPlan, ...]
    params: object = None           # pre-quantized serve params (or None)
    # LM dispatch verdicts (dense_plan_key / attn_plan_key -> engine) and
    # autotune measurements (autotune_key -> (engine, {engine: us}))
    dense_table: dict = dataclasses.field(default_factory=dict)
    autotune: dict = dataclasses.field(default_factory=dict)
    attn_table: dict = dataclasses.field(default_factory=dict)
    version: int = PLAN_VERSION

    def meta(self) -> dict:
        """JSON-ready metadata (everything but the params), with the
        reference's keys."""
        return dict(
            version=self.version, kind=self.kind, model=self.model,
            backend=self.backend, quant=dataclasses.asdict(self.quant),
            batch_hints=list(self.batch_hints),
            layers=[_layer_to_json(lp) for lp in self.layers],
            dense_table=[[list(k), v] for k, v in
                         sorted(self.dense_table.items())],
            attn_table=[[list(k), v] for k, v in
                        sorted(self.attn_table.items())],
            autotune=[[list(k), v[0], v[1]] for k, v in
                      sorted(self.autotune.items(), key=lambda kv: kv[0])],
        )

    def fingerprint(self) -> str:
        """Stable short hash of the metadata (checkpoint tags, engine
        program keys)."""
        blob = json.dumps(self.meta(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def _dispatch_table(self) -> dict:
        """Every verdict this plan installs (dense GEMMs + attention)."""
        return {**self.dense_table, **self.attn_table}

    def install(self) -> "ModelPlan":
        """Install this plan's verdicts process-wide (a server with one
        plan, installed once at start-up)."""
        ops.install_plan_table(self._dispatch_table())
        return self

    @contextlib.contextmanager
    def activate(self):
        """Scoped install: dense and attention dispatch consult this plan's
        tables while the context is open; on exit every key it touched
        gets its prior verdict back (or none), so an outer install or
        activation survives."""
        table = self._dispatch_table()
        prior = {k: ops._PLAN_TABLE[k] for k in table if k in ops._PLAN_TABLE}
        ops.install_plan_table(table)
        try:
            yield self
        finally:
            ops.remove_plan_table({k: None for k in table if k not in prior})
            if prior:
                ops.install_plan_table(prior)


def _tree_device(tree, default) -> torch.device:
    """The device of the first tensor in a params tree, else ``default``."""
    if torch.is_tensor(tree):
        return tree.device
    items = (tree.values() if isinstance(tree, dict)
             else tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        dev = _tree_device(v, None)
        if dev is not None:
            return dev
    return None if default is None else torch.device(default)


def _verified(plan: "ModelPlan", verify: bool) -> "ModelPlan":
    """``plan``, proven first when ``verify`` (raises
    :class:`repro_torch.analysis.prover.PlanVerificationError`)."""
    if verify:
        from repro_torch.analysis.prover import assert_plan_verified

        assert_plan_verified(plan)
    return plan


def _resolve_engine(quant: QuantConfig, m: int, k: int, n: int, target: str,
                    conv, *, autotune: bool = False, device=None,
                    signed: bool = False, act_dtype=torch.float32,
                    strict: bool = True, layer_desc: str) -> tuple[str, str]:
    """One layer's engine verdict -> (engine, source).  ``strict=False``
    takes an explicit engine without the feasibility check."""
    if quant.engine not in ("auto", "fp"):
        if not strict:
            return quant.engine, "override"
        ok, reason = ops.engine_feasible(quant.engine, m, k, n, quant.a_bits,
                                         quant.w_bits, target, conv)
        if not ok:
            raise PlanError(f"{layer_desc}: explicit engine "
                            f"{quant.engine!r} is infeasible on {target!r}: "
                            f"{reason}")
        return quant.engine, "override"
    if autotune:
        eng, _ = ops.autotune_engine(m, k, n, quant.a_bits, quant.w_bits,
                                     target, conv, device=device,
                                     signed=signed, act_dtype=act_dtype)
        return eng, "autotuned"
    # the cost model, never select_engine: a compiling plan must not absorb
    # another plan's installed verdicts or cached measurements
    return (ops.cost_model_engine(m, k, n, quant.a_bits, quant.w_bits,
                                  target, conv), "heuristic")


def _plan_cnn_layers(spec, quant: QuantConfig, *, batches, img_hw, target,
                     autotune: bool = False, device=None,
                     strict: bool = True):
    """Trace the forward's shape evolution (fc resize, SAME/VALID policy,
    2x2 pools) and resolve one engine per (layer, batch hint).
    ``strict=False`` takes an explicit engine unchecked: an infeasible one
    then fails at its kernel's wrapper."""
    from repro_torch.core.conv_lowering import _out_hw

    layers = []
    in_h, in_w = img_hw
    for i, s in enumerate(spec):
        pad = "VALID" if (s.fc or s.k == 1) else "SAME"
        if s.fc and s.k > 1 and in_h != s.k:
            in_h = in_w = s.k       # the forward resizes to (k, k)
        out_h, out_w = _out_hw(in_h, in_w, s.k, s.k, s.stride, pad)
        kdim = s.k * s.k * s.cin
        name = f"{'fc' if s.fc else 'conv'}{i}"
        fp = is_fp_layer(s, quant)
        if fp:
            engines, source = tuple((b, "fp") for b in batches), "fp"
        else:
            resolved = []
            for b in batches:
                conv = ops.ConvShape(in_h, in_w, s.k, s.k, s.stride, pad,
                                     batch=b)
                eng, source = _resolve_engine(
                    quant, b * out_h * out_w, kdim, s.cout, target, conv,
                    autotune=autotune, device=device, strict=strict,
                    layer_desc=f"layer {i} ({name}, {s.k}x{s.k} "
                               f"cin={s.cin} cout={s.cout} batch={b})")
                resolved.append((b, eng))
            engines = tuple(resolved)
        layers.append(LayerPlan(
            index=i, name=name, op="conv", role=s.role, fp=fp,
            kh=s.k, kw=s.k, stride=s.stride, padding=pad,
            cin=s.cin, cout=s.cout, in_h=in_h, in_w=in_w,
            out_h=out_h, out_w=out_w, k=kdim,
            a_bits=quant.a_bits, w_bits=quant.w_bits,
            engine=engines[0][1], engine_source=source, engines=engines,
            pool=s.pool, fc=s.fc))
        in_h, in_w = out_h, out_w
        if s.pool:
            in_h, in_w = max(in_h // 2, 1), max(in_w // 2, 1)
    return tuple(layers)


def _annotate_costs(layers: tuple, target: str) -> tuple:
    """Attach the compile target's per-layer (energy_pj, cycles,
    bytes_moved) roofline estimate to each LayerPlan."""
    from repro_torch.api.targets import LayerGeometry, target_for_backend
    from repro_torch.pim.mapper import effective_bits

    t = target_for_backend(target)
    out = []
    for lp in layers:
        c = t.cost(LayerGeometry(lp.out_h * lp.out_w, lp.k, lp.cout),
                   *effective_bits(lp))
        out.append(dataclasses.replace(
            lp, cost=(c.energy_pj, c.cycles, c.bytes_moved)))
    return tuple(out)


def _pack_faithful_weights(params, layers):
    """Copies of the layer dicts, with ``w_planes`` added where any batch
    hint runs the faithful engine."""
    out = []
    for lp, p in zip(layers, params):
        p = dict(p)
        if any(e == "faithful" for _, e in lp.engines):
            p["w_planes"] = ops.pack_weight_planes(p["w_lv"], lp.w_bits)
        out.append(p)
    return out


def compile_model(params, spec, quant: QuantConfig, *, target: str = "cuda",
                  batch_hints=(1,), img_hw=40, autotune: bool = False,
                  model: str = "cnn", verify: bool = True) -> ModelPlan:
    """Compile a CNN serve plan.  ``params`` (float or prequantized, on any
    device) are pre-quantized once on their own device; ``params=None``
    gives a structure-only plan.  An explicit ``quant.engine`` that is
    infeasible on ``target`` raises :class:`PlanError` naming the layer.
    Layers on the faithful engine carry ``w_planes``, their weight levels
    packed into bit planes once, here.

    ``autotune=True`` times every layer's candidate engines at every batch
    hint on the params' device (the target's own for a structure-only
    plan) and keeps the measurements in ``ModelPlan.autotune``.
    ``verify`` (default) proves the plan before returning it (a violation
    raises :class:`~repro_torch.analysis.prover.PlanVerificationError`, a
    :class:`PlanError`)."""
    from repro_torch.api.targets import get_target

    target = get_target(target).name
    if isinstance(img_hw, int):
        img_hw = (img_hw, img_hw)
    batch_hints = tuple(int(b) for b in batch_hints) or (1,)
    device = _tree_device(params, target)
    layers = _annotate_costs(
        _plan_cnn_layers(tuple(spec), quant, batches=batch_hints,
                         img_hw=tuple(img_hw), target=target,
                         autotune=autotune, device=device), target)
    serve_params = None
    if params is not None:
        serve_params = (params if is_prequantized(params)
                        else prequantize_cnn_params(params, spec, quant))
        serve_params = _pack_faithful_weights(serve_params, layers)
    tuned = {}
    if autotune:   # heuristic plans carry no measurements
        for lp in layers:
            if lp.fp:
                continue
            for b, _ in lp.engines:
                key = ops.autotune_key(
                    b * lp.out_h * lp.out_w, lp.k, lp.cout, lp.a_bits,
                    lp.w_bits, device.type,
                    ops.ConvShape(lp.in_h, lp.in_w, lp.kh, lp.kw,
                                  lp.stride, lp.padding, batch=b))
                if key in ops._AUTOTUNE_CACHE:
                    tuned[key] = ops._AUTOTUNE_CACHE[key]
    return _verified(ModelPlan(
        kind="cnn", model=model, backend=target, quant=quant,
        batch_hints=batch_hints, layers=layers, params=serve_params,
        autotune=tuned), verify)


# The per-call plan of the legacy entry point (``cnn_forward(mode="serve")``
# with no compiled plan): cached per (spec, quant, shape, target); the
# dispatch epoch in the key keeps a changed verdict source from serving
# stale layers.
@functools.lru_cache(maxsize=512)
def _cached_cnn_layers(spec_t, quant, batch, img_hw, target, _epoch):
    return _plan_cnn_layers(spec_t, quant, batches=(batch,), img_hw=img_hw,
                            target=target, strict=False)


def cnn_serve_layers(spec, quant: QuantConfig, *, batch: int, img_hw,
                     target: str = "cuda"):
    """Per-call plan for ``cnn_forward(mode="serve")``: the engine choices
    a compiled plan makes at this batch, without its proof or cost
    annotations, and taking an explicit engine unchecked (an infeasible
    one fails at its kernel's wrapper, never on another engine)."""
    return _cached_cnn_layers(tuple(spec), quant, int(batch),
                              (int(img_hw[0]), int(img_hw[1])), target,
                              ops.dispatch_epoch())


def _layer_weights(p: dict, lp: LayerPlan):
    """A quantized layer's ``(w_lv, s_w, z_w)``: the plan's prequantized
    levels, or a float ``w`` prequantized here, at the call."""
    if "w_lv" in p:
        return p["w_lv"], p["s_w"], p["z_w"]
    return prequantize_conv_weight(p["w"], lp.w_bits)


def execute_cnn_layers(layers, params, x: torch.Tensor, quant: QuantConfig,
                       reference: bool = False) -> torch.Tensor:
    """Run the compiled layer sequence.  x (B,H,W,C) in [0,1] -> logits.
    Layer dicts carry prequantized levels or, as float checkpoints, ``w``
    (prequantized at the call); a faithful layer without ``w_planes``
    packs them at the call.  ``reference=True`` runs the kernels' plain
    versions (the oracle).  Each layer's convolution is an
    ``executor.conv`` span, each norm an ``executor.norm`` span."""
    from repro_torch.core.conv_lowering import conv2d_float, quant_conv2d_pre
    from repro_torch.models.cnn import _norm_act, avg_pool2, resize_linear

    if len(params) != len(layers):
        raise PlanError(f"{len(params)} layers of params for a plan of "
                        f"{len(layers)} layers")
    h = x
    last = len(layers) - 1
    for lp, p in zip(layers, params):
        if lp.fc and lp.kh > 1 and h.shape[1] != lp.kh:
            h = resize_linear(h, lp.kh)
        with TRACER.span("executor.conv"):
            if lp.fp:
                h = conv2d_float(h, p["w"], stride=lp.stride,
                                 padding=lp.padding)
            else:
                w_lv, s_w, z_w = _layer_weights(p, lp)
                h = quant_conv2d_pre(
                    h, w_lv, s_w, z_w, kh=lp.kh, kw=lp.kw,
                    stride=lp.stride, padding=lp.padding, a_bits=lp.a_bits,
                    w_bits=lp.w_bits, engine=lp.engine,
                    w_planes=p.get("w_planes"), reference=reference)
        if lp.index < last:
            with TRACER.span("executor.norm"):
                h = _norm_act(h, p["g"], p["beta"], quant, lp.role, "serve",
                              bias=p["b"], reference=reference)
        else:
            h = h + p["b"]
        if lp.pool:
            h = avg_pool2(h)
    return torch.mean(h, dim=(1, 2))


def layers_for_batch(plan: ModelPlan, batch: int):
    """The plan's layers with engines re-pinned for ``batch``."""
    return tuple(dataclasses.replace(lp, engine=lp.engine_at(batch))
                 for lp in plan.layers)


def plan_forward(plan: ModelPlan, x: torch.Tensor, params=None,
                 reference: bool = False) -> torch.Tensor:
    """Execute a compiled CNN plan on ``x`` (on the params' device): an
    ``executor.plan`` span, the host's enqueue of one forward."""
    if plan.kind != "cnn":
        raise PlanError(f"plan_forward executes CNN plans, got {plan.kind!r}")
    params = plan.params if params is None else params
    if params is None:
        raise PlanError("structure-only plan (compiled with params=None) "
                        "cannot execute")
    with TRACER.span("executor.plan"):
        return execute_cnn_layers(layers_for_batch(plan, int(x.shape[0])),
                                  params, x, plan.quant, reference=reference)


def plan_energy_pj(plan: ModelPlan) -> float:
    """Modeled energy of one forward through the plan, in pJ: the sum of
    the per-layer cost annotations (the degrade policy's budget currency;
    a dispatch of padded batch B spends ``B * plan_energy_pj(plan)``)."""
    return float(sum(lp.cost[0] for lp in plan.layers if lp.cost))


def plan_cost_on(plan: ModelPlan, target) -> dict:
    """Price one forward of a compiled CNN plan on a PIM target (name or
    instance) — the reference's Table-II arithmetic, float for float."""
    from repro_torch.api.targets import PIMTarget, get_target
    from repro_torch.pim.mapper import works_from_layers

    t = get_target(target) if isinstance(target, str) else target
    if not isinstance(t, PIMTarget):
        raise PlanError(f"plan_cost_on prices PIM targets (got {t.name!r})")
    report = dict(t.report(works_from_layers(plan.layers)))
    report["target"] = t.name
    return report


# ---------------------------------------------------------------------------
# LM compile pass
# ---------------------------------------------------------------------------

def _lm_is_prequantized(params) -> bool:
    return any(isinstance(v, dict) and "q" in v
               for tree in params["blocks"].values()
               for sv in tree.values() if isinstance(sv, dict)
               for v in sv.values())


def compile_lm(params, cfg, *, target: str = "cuda", batch_hints=(1,),
               prompt_len: int = 16, autotune: bool = False,
               page_size: int | None = None, kv_pages: int | None = None,
               verify: bool = True) -> ModelPlan:
    """Compile a transformer serve plan: pre-quantize every projection once
    (``params``: the port's LM tree, float or already prequantized, on any
    device) and resolve one verdict per distinct (K, N) GEMM into the
    dense table, ``m``-free, so one entry covers prefill and every decode
    step.  Verdicts outside :data:`SIGNED_ENGINES` map to ``int8``, as the
    signed serve path does.  ``autotune=True`` times the signed candidates
    at ``batch_hints[0] * prompt_len`` rows on the params' device.

    ``page_size`` / ``kv_pages`` declare the continuous engine's paged
    geometry (``kv_pages`` = the page-table width): the plan then carries
    a ``paged`` verdict for its decode step.  ``verify`` (default) proves
    the plan before returning it."""
    from repro_torch.api.targets import LayerGeometry, get_target
    from repro_torch.models.layers import PREQUANT_KEYS, prequantize_params

    cost_target = get_target(target)
    target = cost_target.name
    quant = cfg.quant
    batch_hints = tuple(int(b) for b in batch_hints) or (1,)
    quantized = not (quant.engine == "fp" or quant.w_bits >= 32)
    serve_params = params
    if quantized and not _lm_is_prequantized(params):
        serve_params = prequantize_params(params, cfg)
    device = _tree_device(params, target)

    layers, table = [], {}
    if quantized:
        shapes: dict[tuple, str] = {}
        for kind, tree in sorted(serve_params["blocks"].items()):
            for sub, sv in sorted(tree.items()):
                if not isinstance(sv, dict):
                    continue
                for kname, v in sorted(sv.items()):
                    if kname in PREQUANT_KEYS:
                        shapes.setdefault(
                            (int(v["q"].shape[-2]), int(v["q"].shape[-1])),
                            f"{kind}.{sub}.{kname}")
        m = batch_hints[0] * prompt_len
        for i, ((K, N), name) in enumerate(sorted(shapes.items())):
            eng, source = _resolve_engine(
                quant, m, K, N, target, None, autotune=autotune,
                device=device, signed=True, act_dtype=cfg.compute_dtype,
                layer_desc=f"projection {name} (K={K}, N={N})")
            if eng not in SIGNED_ENGINES:
                eng = "int8"
            table[ops.dense_plan_key(K, N, quant.a_bits, quant.w_bits,
                                     target)] = eng
            c = cost_target.cost(LayerGeometry(m, K, N), quant.a_bits,
                                 quant.w_bits)
            layers.append(LayerPlan(
                index=i, name=name, op="dense", role="mid", fp=False,
                kh=0, kw=0, stride=1, padding="", cin=K, cout=N,
                in_h=0, in_w=0, out_h=0, out_w=0, k=K,
                a_bits=quant.a_bits, w_bits=quant.w_bits, engine=eng,
                engine_source=source,
                engines=tuple((b, eng) for b in batch_hints),
                cost=(c.energy_pj, c.cycles, c.bytes_moved)))
    attn_table = _plan_lm_attention(
        serve_params, cfg, quant, cost_target, batch_hints, prompt_len,
        layers, page_size=page_size, kv_pages=kv_pages)
    tuned = {}
    if autotune:   # heuristic plans carry no measurements
        tuned = {k: v for k, v in ops._AUTOTUNE_CACHE.items()
                 if k[0] == "signed" and k[-1] == device.type
                 and any(k[2:4] == (lp.k, lp.cout) for lp in layers)}
    return _verified(ModelPlan(
        kind="lm", model=getattr(cfg, "name", "lm"), backend=target,
        quant=quant, batch_hints=batch_hints, layers=tuple(layers),
        params=serve_params, dense_table=table, attn_table=attn_table,
        autotune=tuned), verify)


def _attn_row(index: int, name: str, attn, eng: str, cfg, quant,
              batch_hints, cost_target) -> LayerPlan:
    c = cost_target.attn_cost(attn)
    return LayerPlan(
        index=index, name=name, op="attn", role="mid", fp=not attn.quantized,
        kh=0, kw=0, stride=1, padding="", cin=cfg.d_model, cout=cfg.d_model,
        in_h=0, in_w=0, out_h=0, out_w=0, k=cfg.hd, a_bits=quant.a_bits,
        w_bits=quant.w_bits, engine=eng, engine_source="heuristic",
        engines=tuple((b, eng) for b in batch_hints),
        cost=(c.energy_pj, c.cycles, c.bytes_moved), attn_engine=eng)


def _plan_lm_attention(params, cfg, quant: QuantConfig, cost_target,
                       batch_hints: tuple, prompt_len: int, layers: list,
                       page_size: int | None = None,
                       kv_pages: int | None = None) -> dict:
    """One attention verdict per window geometry (global-attention kinds
    share one), from the target's own decision procedure, and with
    ``page_size`` one more for the paged decode step (10-tuple key).
    Appends an ``op="attn"`` row per verdict to ``layers``; returns the
    attention table."""
    from repro_torch.models.layers import analysis_attn_engine, attn_quantized

    backend = cost_target.name
    attn_table: dict = {}
    seen: set = set()
    for kind in sorted(params["blocks"]):
        if kind not in ("attn", "moe", "attn_local"):
            continue
        window = cfg.window if kind == "attn_local" else None
        if window in seen:
            continue
        seen.add(window)
        attn = ops.AttnShape(
            seq_q=prompt_len, seq_kv=prompt_len, heads=cfg.n_heads,
            head_dim=cfg.hd, causal=bool(cfg.causal), window=window,
            batch=batch_hints[0], quantized=attn_quantized(quant, "serve"),
            banded_ok=bool(getattr(cfg, "banded_attn", False)))
        eng = analysis_attn_engine(cfg, cost_target.select_attn_engine(attn))
        attn_table[ops.attn_plan_key(attn, backend)] = eng
        layers.append(_attn_row(len(layers), f"attn[{kind}]", attn, eng, cfg,
                                quant, batch_hints, cost_target))
    if page_size is not None:
        if not kv_pages or kv_pages < 1:
            raise ValueError(f"page_size={page_size} needs kv_pages >= 1 "
                             f"(per-request page budget), got {kv_pages}")
        # the continuous engine's decode step: one query token per slot
        # against kv_pages pages
        attn = ops.AttnShape(
            seq_q=1, seq_kv=page_size * kv_pages, heads=cfg.n_heads,
            head_dim=cfg.hd, causal=bool(cfg.causal), window=None,
            batch=max(batch_hints), quantized=attn_quantized(quant, "serve"),
            page_size=page_size)
        eng = cost_target.select_attn_engine(attn)
        attn_table[ops.attn_plan_key(attn, backend)] = eng
        layers.append(_attn_row(len(layers),
                                f"attn[paged {kv_pages}x{page_size}]", attn,
                                eng, cfg, quant, batch_hints, cost_target))
    return attn_table


# ---------------------------------------------------------------------------
# Serialization: JSON metadata + npz weight levels (the reference's layout)
# ---------------------------------------------------------------------------

# derived on load from the levels, never stored (packing is not
# requantization)
_DERIVED = ("w_planes",)


def _layer_to_json(lp: LayerPlan) -> dict:
    d = dataclasses.asdict(lp)
    d["engines"] = [list(e) for e in lp.engines]
    d["cost"] = list(lp.cost)
    return d


def _layer_from_json(d: dict) -> LayerPlan:
    d = dict(d)
    d["engines"] = tuple((int(b), str(e)) for b, e in d["engines"])
    d["cost"] = tuple(float(c) for c in d.get("cost", ()))
    return LayerPlan(**d)


def _host_array(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()  # repro-lint: disable=RL002 — save_plan writes to disk
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def _skeletonize(tree, prefix: str, out: dict):
    """Nested dict/list params -> JSON skeleton + flat {path: ndarray}."""
    if isinstance(tree, dict):
        return {k: _skeletonize(v, f"{prefix}/{k}", out)
                for k, v in tree.items() if k not in _DERIVED}
    if isinstance(tree, (list, tuple)):
        return [_skeletonize(v, f"{prefix}/{i}", out)
                for i, v in enumerate(tree)]
    out[prefix] = _host_array(tree)
    return {"__leaf__": prefix}


def _reconstitute(skel, npz):
    """JSON skeleton + npz -> nested dict/list of numpy arrays."""
    if isinstance(skel, dict):
        if set(skel) == {"__leaf__"}:
            return np.asarray(npz[skel["__leaf__"]])
        return {k: _reconstitute(v, npz) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_reconstitute(v, npz) for v in skel]
    raise PlanError(f"invalid params skeleton node: {skel!r}")


def _params_to_device(params, layers, device) -> list[dict]:
    """numpy layer dicts -> the port's serve params on ``device``
    (``convert.cnn_params_from_numpy``: uint8 levels, the scales as Python
    floats, the rest float32), each layer's levels checked against its
    bit width first, faithful layers' weight planes packed."""
    from repro_torch.convert import cnn_params_from_numpy

    if len(params) != len(layers):
        raise PlanError(f"plan holds {len(layers)} layers but "
                        f"{len(params)} param dicts")
    for lp, p in zip(layers, params):
        a = p.get("w_lv")
        top = (1 << lp.w_bits) - 1
        if a is not None and a.size and (a.min() < 0 or a.max() > top):
            raise PlanError(f"layer {lp.index} ({lp.name}): weight levels "
                            f"[{a.min()}, {a.max()}] outside [0, {top}] for "
                            f"w_bits={lp.w_bits}")
    return _pack_faithful_weights(cnn_params_from_numpy(params, device),
                                  layers)


def _plan_base(path: str) -> str:
    return path[:-5] if path.endswith(".json") else path


def plan_exists(path: str) -> bool:
    """Is a serialized plan present at ``path`` (with or without .json)?"""
    return os.path.exists(_plan_base(path) + ".json")


def check_plan_matches(plan: ModelPlan, *, quant: QuantConfig | None = None,
                       model: str | None = None,
                       backend: str | None = None) -> ModelPlan:
    """Guard a reloaded plan against the caller's configuration: a plan
    compiled under other bit widths would decode its stored levels into
    wrong numbers without any shape error, so a mismatch raises
    :class:`PlanError` asking for a recompile."""
    if quant is not None and plan.quant != quant:
        raise PlanError(
            f"plan was compiled for quant {plan.quant.tag()!r} "
            f"(engine={plan.quant.engine!r}) but the current config is "
            f"{quant.tag()!r} (engine={quant.engine!r}) — delete the plan "
            "file or point the cache elsewhere to recompile")
    if model is not None and plan.model != model:
        raise PlanError(f"plan was compiled for model {plan.model!r}, "
                        f"current model is {model!r} — recompile")
    if backend is not None and plan.backend != backend:
        raise PlanError(f"plan was compiled for backend {plan.backend!r}, "
                        f"live backend is {backend!r} — recompile")
    return plan


def save_plan(plan: ModelPlan, path: str) -> str:
    """Write ``<path>.json`` (metadata) + ``<path>.npz`` (levels, scales,
    float params); returns the JSON path.  Faithful weight planes are not
    stored: :func:`load_plan` packs them from the levels."""
    base = _plan_base(path)
    os.makedirs(os.path.dirname(os.path.abspath(base)), exist_ok=True)
    meta = plan.meta()
    if plan.params is not None:
        arrays: dict[str, np.ndarray] = {}
        meta["params_skel"] = _skeletonize(plan.params, "p", arrays)
        np.savez(base + ".npz", **arrays)
        meta["params_npz"] = os.path.basename(base) + ".npz"
    else:
        meta["params_skel"] = None
        meta["params_npz"] = None
    with open(base + ".json", "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return base + ".json"


def _read_plan(path: str):
    """(metadata, numpy params or None) of a serialized plan."""
    base = _plan_base(path)
    with open(base + ".json") as f:
        meta = json.load(f)
    if meta.get("version") != PLAN_VERSION:
        raise PlanError(f"plan version {meta.get('version')!r} != "
                        f"{PLAN_VERSION} (recompile the plan)")
    if meta.get("kind") not in ("cnn", "lm"):
        raise PlanError(f"{base}.json is a {meta.get('kind')!r} plan "
                        "(kinds: cnn, lm)")
    params = None
    if meta.get("params_skel") is not None:
        npz_path = os.path.join(os.path.dirname(os.path.abspath(base)),
                                meta["params_npz"])
        with np.load(npz_path) as npz:
            params = _reconstitute(meta["params_skel"], npz)
    return meta, params


def _plan_from_meta(meta: dict, params, device, *, backend=None,
                    layers=None) -> ModelPlan:
    from repro_torch.convert import lm_params_from_numpy

    layers = (tuple(_layer_from_json(d) for d in meta["layers"])
              if layers is None else layers)
    quant = QuantConfig(**meta["quant"])
    if params is not None:
        params = (lm_params_from_numpy(params, quant, device)
                  if meta["kind"] == "lm"
                  else _params_to_device(params, layers, device))
    return ModelPlan(
        kind=meta["kind"], model=meta["model"],
        backend=backend or meta["backend"], quant=quant,
        batch_hints=tuple(meta["batch_hints"]), layers=layers,
        params=params,
        dense_table={tuple(k): v for k, v in meta.get("dense_table", [])},
        attn_table={tuple(k): v for k, v in meta.get("attn_table", [])},
        autotune={tuple(k): (eng, times)
                  for k, eng, times in meta.get("autotune", [])},
        version=meta["version"])


def load_plan(path: str, device="cuda") -> ModelPlan:
    """Reload a plan written by :func:`save_plan`, its params on
    ``device``.  Nothing is requantized, and the plan's autotune
    measurements go back into the cache, so even a recompile of the same
    shapes measures nothing."""
    meta, params = _read_plan(path)
    plan = _plan_from_meta(meta, params, device)
    if plan.autotune:
        ops._AUTOTUNE_CACHE.update(plan.autotune)
        ops._DISPATCH_EPOCH[0] += 1
    return plan

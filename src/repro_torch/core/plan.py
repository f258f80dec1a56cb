"""Compile-once execution plans (port of the CNN half of
``repro/core/plan.py``).

:func:`compile_model` resolves every layer's engine at every batch hint
and pre-quantizes the weights once; :func:`plan_forward` walks the
resulting :class:`ModelPlan`.  An explicit ``QuantConfig.engine`` (any of
the reference's dense engines) pins every quantized layer; the faithful
engine's weight planes are packed once, at compile.  Not ported yet: the
static prover,
autotune, per-layer cost annotations, ``save_plan``/``load_plan`` and the
LM compile pass.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.prequant import (is_fp_layer, is_prequantized,
                                       prequantize_cnn_params)
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops


class PlanError(ValueError):
    """A plan could not be compiled or executed; the message names the
    offending layer."""


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's compiled execution record.  ``engine`` is the verdict at
    the primary batch hint; ``engines`` the ``(batch_hint, engine)`` table."""

    index: int
    name: str
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
    engine_source: str      # fp | override | heuristic
    engines: tuple          # ((batch_hint, engine), ...)
    pool: bool = False
    fc: bool = False

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
    """A compiled execution plan for one CNN on one compute target."""

    target: str                     # compute target name ("cuda")
    quant: QuantConfig
    layers: tuple                   # tuple[LayerPlan, ...]
    params: object = None           # pre-quantized serve params (or None)


def _resolve_engine(quant: QuantConfig, m: int, k: int, n: int, target: str,
                    conv, layer_desc: str) -> tuple[str, str]:
    if quant.engine not in ("auto", "fp"):
        ok, reason = ops.engine_feasible(quant.engine, m, k, n, quant.a_bits,
                                         quant.w_bits, target, conv)
        if not ok:
            raise PlanError(f"{layer_desc}: explicit engine "
                            f"{quant.engine!r} is infeasible on {target!r}: "
                            f"{reason}")
        return quant.engine, "override"
    return (ops.select_engine(m, k, n, quant.a_bits, quant.w_bits, target,
                              conv), "heuristic")


def _plan_cnn_layers(spec, quant: QuantConfig, *, batches, img_hw, target):
    """Trace the forward's shape evolution (fc resize, SAME/VALID policy,
    2x2 pools) and resolve one engine per (layer, batch hint)."""
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
                    layer_desc=f"layer {i} ({name}, {s.k}x{s.k} "
                               f"cin={s.cin} cout={s.cout} batch={b})")
                resolved.append((b, eng))
            engines = tuple(resolved)
        layers.append(LayerPlan(
            index=i, name=name, role=s.role, fp=fp,
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
                  batch_hints=(1,), img_hw=40) -> ModelPlan:
    """Compile a CNN serve plan.  ``params`` (float or prequantized, on any
    device) are pre-quantized once on their own device; ``params=None``
    gives a structure-only plan.  An explicit ``quant.engine`` that is
    infeasible on ``target`` raises :class:`PlanError` naming the layer.
    Layers on the faithful engine carry ``w_planes``, their weight levels
    packed into bit planes once, here."""
    from repro_torch.api.targets import get_target

    target = get_target(target).name
    if isinstance(img_hw, int):
        img_hw = (img_hw, img_hw)
    batch_hints = tuple(int(b) for b in batch_hints) or (1,)
    layers = _plan_cnn_layers(tuple(spec), quant, batches=batch_hints,
                              img_hw=tuple(img_hw), target=target)
    serve_params = None
    if params is not None:
        serve_params = (params if is_prequantized(params)
                        else prequantize_cnn_params(params, spec, quant))
        serve_params = _pack_faithful_weights(serve_params, layers)
    return ModelPlan(target=target, quant=quant, layers=layers,
                     params=serve_params)


def execute_cnn_layers(layers, params, x: torch.Tensor, quant: QuantConfig,
                       reference: bool = False) -> torch.Tensor:
    """Run the compiled layer sequence.  x (B,H,W,C) in [0,1] -> logits.
    ``reference=True`` runs the kernels' plain versions (the oracle)."""
    from repro_torch.core.conv_lowering import conv2d_float, quant_conv2d_pre
    from repro_torch.models.cnn import _norm_act, avg_pool2, resize_linear

    h = x
    last = len(layers) - 1
    for lp, p in zip(layers, params):
        if lp.fc and lp.kh > 1 and h.shape[1] != lp.kh:
            h = resize_linear(h, lp.kh)
        if lp.fp:
            h = conv2d_float(h, p["w"], stride=lp.stride, padding=lp.padding)
        else:
            h = quant_conv2d_pre(
                h, p["w_lv"], p["s_w"], p["z_w"], kh=lp.kh, kw=lp.kw,
                stride=lp.stride, padding=lp.padding, a_bits=lp.a_bits,
                w_bits=lp.w_bits, engine=lp.engine,
                w_planes=p.get("w_planes"), reference=reference)
        h = h + p["b"]
        if lp.index < last:
            h = _norm_act(h, p["g"], p["beta"], quant, lp.role, "serve")
        if lp.pool:
            h = avg_pool2(h)
    return torch.mean(h, dim=(1, 2))


def layers_for_batch(plan: ModelPlan, batch: int):
    """The plan's layers with engines re-pinned for ``batch``."""
    return tuple(dataclasses.replace(lp, engine=lp.engine_at(batch))
                 for lp in plan.layers)


def plan_forward(plan: ModelPlan, x: torch.Tensor, params=None,
                 reference: bool = False) -> torch.Tensor:
    """Execute a compiled CNN plan on ``x`` (on the params' device)."""
    params = plan.params if params is None else params
    if params is None:
        raise PlanError("structure-only plan (compiled with params=None) "
                        "cannot execute")
    return execute_cnn_layers(layers_for_batch(plan, int(x.shape[0])),
                              params, x, plan.quant, reference=reference)


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

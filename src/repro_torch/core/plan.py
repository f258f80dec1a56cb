"""Compile-once execution plans (port of the CNN half of
``repro/core/plan.py``).

:func:`compile_model` resolves every layer's engine at every batch hint,
annotates each layer with the compile target's roofline cost and
pre-quantizes the weights once; :func:`plan_forward` walks the resulting
:class:`ModelPlan`.  An explicit ``QuantConfig.engine`` (any of the
reference's dense engines) pins every quantized layer; the faithful
engine's weight planes are packed once, at compile or load.

:func:`save_plan` / :func:`load_plan` write and read the reference's
on-disk layout (``<path>.json`` metadata + ``<path>.npz`` levels, the same
``PLAN_VERSION``): a restarted node reloads its plan and never
requantizes.  ``ModelPlan.meta()`` carries the reference's keys, so a
plan's :meth:`~ModelPlan.fingerprint` hashes the same fields.  Not ported
yet: the static prover, autotune and the LM compile pass.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.core.prequant import (is_fp_layer, is_prequantized,
                                       prequantize_cnn_params)
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops

PLAN_VERSION = 1


class PlanError(ValueError):
    """A plan could not be compiled or executed; the message names the
    offending layer."""


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's compiled execution record.  ``engine`` is the verdict at
    the primary batch hint; ``engines`` the ``(batch_hint, engine)`` table."""

    index: int
    name: str
    op: str                 # "conv" (the only op a CNN plan holds)
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
    """A compiled, serializable execution plan for one CNN on one compute
    target (``backend``: the target's name, ``cuda``)."""

    kind: str                       # "cnn"
    model: str
    backend: str
    quant: QuantConfig
    batch_hints: tuple
    layers: tuple                   # tuple[LayerPlan, ...]
    params: object = None           # pre-quantized serve params (or None)
    # the reference's LM dispatch tables and autotune measurements: empty
    # in a CNN plan, kept so meta() has the reference's keys
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
                  batch_hints=(1,), img_hw=40,
                  model: str = "cnn") -> ModelPlan:
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
    layers = _annotate_costs(
        _plan_cnn_layers(tuple(spec), quant, batches=batch_hints,
                         img_hw=tuple(img_hw), target=target), target)
    serve_params = None
    if params is not None:
        serve_params = (params if is_prequantized(params)
                        else prequantize_cnn_params(params, spec, quant))
        serve_params = _pack_faithful_weights(serve_params, layers)
    return ModelPlan(kind="cnn", model=model, backend=target, quant=quant,
                     batch_hints=batch_hints, layers=layers,
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
        return leaf.detach().cpu().numpy()
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
    if meta.get("kind") != "cnn":
        raise PlanError(f"{base}.json is a {meta.get('kind')!r} plan; the "
                        "port loads CNN plans (LM plans are not yet ported)")
    params = None
    if meta.get("params_skel") is not None:
        npz_path = os.path.join(os.path.dirname(os.path.abspath(base)),
                                meta["params_npz"])
        with np.load(npz_path) as npz:
            params = _reconstitute(meta["params_skel"], npz)
    return meta, params


def _plan_from_meta(meta: dict, params, device, *, backend=None,
                    layers=None) -> ModelPlan:
    layers = (tuple(_layer_from_json(d) for d in meta["layers"])
              if layers is None else layers)
    if params is not None:
        params = _params_to_device(params, layers, device)
    return ModelPlan(
        kind=meta["kind"], model=meta["model"],
        backend=backend or meta["backend"],
        quant=QuantConfig(**meta["quant"]),
        batch_hints=tuple(meta["batch_hints"]), layers=layers,
        params=params,
        dense_table={tuple(k): v for k, v in meta.get("dense_table", [])},
        attn_table={tuple(k): v for k, v in meta.get("attn_table", [])},
        autotune={tuple(k): (eng, times)
                  for k, eng, times in meta.get("autotune", [])},
        version=meta["version"])


def load_plan(path: str, device="cuda") -> ModelPlan:
    """Reload a plan written by :func:`save_plan`, its params on
    ``device``.  Nothing is requantized."""
    meta, params = _read_plan(path)
    return _plan_from_meta(meta, params, device)

"""Session facade: build -> compile -> forward / serve / simulate / save
(port of ``repro/api/session.py``).

    model    = build(spec, quant, params=params)          # ConvSpec list
    compiled = model.compile(target="cuda", batch_hints=(1, 8),
                             cache="plans/svhn",          # reload or save
                             autotune=True)               # measure engines
    compiled.forward(x)                                   # one batch
    compiled.serve(max_batch=8).predict(images)           # request engine
    compiled.serve(resilience=ResilienceConfig(...),      # fault-surviving
                   fallback=lower_bit_compiled)
    compiled.simulate(target="sot_mram")                  # PIM cost report
    compiled.save("plans/svhn"); load("plans/svhn", device="cuda")

    lm = build(cfg, params=lm_params).compile(prompt_len=2048,
                                              batch_hints=(2,))  # ArchConfig
    lm.serve(new_tokens=16).predict(prompts)              # LMRunner

``simulate`` is pure arithmetic over the plan's geometry and gives the
reference's floats exactly.  ``compile`` proves every plan it returns,
fresh or reloaded (``verify=True``, the default; the static prover of
:mod:`repro_torch.analysis`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np

from repro_torch.core.quant import QuantConfig
from .targets import LayerGeometry, PIMTarget, get_target


def _is_lm(spec) -> bool:
    """An LM ArchConfig (a transformer geometry with its own quant)."""
    return hasattr(spec, "n_layers") and hasattr(spec, "quant")


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Per-model cost on one PIM target, with the per-layer breakdown."""

    target: str
    energy_uj: float
    latency_us: float
    fps: float
    macs: int
    row_ops: int
    bytes_moved: float
    layers: tuple                  # ((layer_name, Cost), ...)
    area_mm2: Optional[float] = None
    fps_per_mm2: Optional[float] = None
    gops_per_w: Optional[float] = None
    eff_per_mm2: Optional[float] = None

    def vs(self, other: "CostReport") -> dict:
        """Headline ratios of this target over ``other``."""
        return dict(energy=other.energy_uj / self.energy_uj,
                    speed=self.fps / other.fps)

    def rows(self) -> list[dict]:
        """CSV-able per-layer rows."""
        return [dict(layer=name, energy_pj=round(c.energy_pj, 1),
                     cycles=round(c.cycles, 1),
                     bytes_moved=round(c.bytes_moved))
                for name, c in self.layers]


class Deployment:
    """A live serving handle over :class:`repro_torch.launch.engine.
    ServeEngine` (or its resilient subclass)."""

    def __init__(self, engine, compiled: "CompiledModel"):
        self.engine = engine
        self.compiled = compiled

    def predict(self, payloads) -> list[np.ndarray]:
        """Closed-loop serve: submit all payloads, drain, values in order."""
        return [r.value for r in self.engine.serve(list(payloads))]

    # queue-level passthroughs for open-loop drivers
    def submit(self, payload, t_submit=None) -> int:
        return self.engine.submit(payload, t_submit=t_submit)

    def pump(self) -> None:
        self.engine.pump()

    def drain(self):
        return self.engine.drain()

    @property
    def stats(self) -> dict:
        return self.engine.stats


@dataclasses.dataclass
class Model:
    """An uncompiled model: a ConvSpec list (CNN) or an ArchConfig (LM),
    its quantization and (optional) params."""

    spec: Any
    quant: QuantConfig
    params: Any = None
    img_hw: Any = 40
    name: str = "cnn"

    @property
    def kind(self) -> str:
        """The model family: "lm" for an ArchConfig, else "cnn"."""
        return "lm" if _is_lm(self.spec) else "cnn"

    def compile(self, *, target: str = "cuda", batch_hints=(1,),
                cache: str | None = None, autotune: bool = False,
                verify: bool = True, prompt_len: int = 16,
                page_size: int | None = None,
                kv_pages: int | None = None) -> "CompiledModel":
        """Compile against a compute target (``cuda``).  Params are
        pre-quantized on the device they live on; ``autotune=True`` times
        the candidate engines there.  LM models take ``prompt_len`` and
        the paged geometry (``page_size``, ``kv_pages``).

        ``cache`` names a plan file: if it exists it is reloaded (guarded
        by :func:`repro_torch.core.plan.check_plan_matches`; nothing is
        requantized or measured) onto the params' device (``cuda`` for a
        structure-only model), otherwise the fresh plan is saved there.
        ``verify`` gates the static plan prover on both paths: a reloaded
        plan is proven after ``check_plan_matches`` and before anything
        runs on it."""
        from repro_torch.core import plan as P

        t = get_target(target)
        if t.kind != "compute":
            raise P.PlanError(
                f"target {target!r} is a simulated PIM design — compile "
                "against a compute target (cuda) and pass the PIM target "
                "to .simulate() instead")
        t0 = time.perf_counter()
        if cache and P.plan_exists(cache):
            plan = P.check_plan_matches(
                P.load_plan(cache, device=P._tree_device(self.params,
                                                         "cuda")),
                quant=self.quant, model=self.name, backend=t.name)
            P._verified(plan, verify)
            return CompiledModel(plan, model=self, cache_path=cache,
                                 reloaded=True,
                                 compile_s=time.perf_counter() - t0)
        if self.kind == "lm":
            plan = P.compile_lm(self.params, self.spec, target=t.name,
                                batch_hints=batch_hints,
                                prompt_len=prompt_len, autotune=autotune,
                                page_size=page_size, kv_pages=kv_pages,
                                verify=verify)
        else:
            plan = P.compile_model(self.params, self.spec, self.quant,
                                   target=t.name, batch_hints=batch_hints,
                                   img_hw=self.img_hw, autotune=autotune,
                                   model=self.name, verify=verify)
        path = P.save_plan(plan, cache) if cache else None
        return CompiledModel(plan, model=self, cache_path=path,
                             reloaded=False,
                             compile_s=time.perf_counter() - t0)


@dataclasses.dataclass
class CompiledModel:
    """A compiled ModelPlan with forward / serve / simulate / save."""

    plan: Any
    model: Optional[Model] = None
    cache_path: Optional[str] = None
    reloaded: bool = False
    compile_s: float = 0.0

    @property
    def params(self):
        return self.plan.params

    @property
    def quant(self) -> QuantConfig:
        return self.plan.quant

    def fingerprint(self) -> str:
        return self.plan.fingerprint()

    def forward(self, x, reference: bool = False):
        """One batched forward through the plan; ``x`` (B,H,W,C) on the
        params' device.  ``reference=True`` uses the kernels' plain
        versions (the on-device oracle)."""
        from repro_torch.core import plan as P

        if self.plan.kind != "cnn":
            raise P.PlanError("forward() executes CNN plans; use serve() "
                              "for LM generation")
        return P.plan_forward(self.plan, x, reference=reference)

    def serve(self, *, max_batch: int = 8, flush_deadline_s: float = 0.005,
              mesh=None, max_pending: int = 4096, new_tokens: int = 16,
              qmode: str = "serve", resilience=None,
              fallback: "CompiledModel | None" = None) -> Deployment:
        """Stand up the request-level serving engine on this plan (an LM
        plan generates ``new_tokens`` per request through ``LMRunner``).
        ``mesh`` (``launch.mesh.make_serve_mesh()``: a sequence of
        devices, or None) makes it data-parallel over those devices.

        ``resilience`` (a :class:`repro_torch.resilience.ResilienceConfig`)
        swaps in the fault-surviving engine; with ``fallback`` (a
        lower-bit CompiledModel of the same network) and a degrade policy
        it falls back to that plan under fault pressure or an energy
        budget."""
        from repro_torch.launch.engine import ServeEngine

        kw = dict(max_batch=max_batch, flush_deadline_s=flush_deadline_s,
                  max_pending=max_pending, mesh=mesh)
        if resilience is not None:
            from repro_torch.resilience import build_resilient_engine

            engine = build_resilient_engine(
                self, resilience, fallback=fallback, new_tokens=new_tokens,
                qmode=qmode, **kw)
        else:
            engine = ServeEngine(self.runner(new_tokens=new_tokens,
                                             qmode=qmode), **kw)
        return Deployment(engine, self)

    def runner(self, *, new_tokens: int = 16, qmode: str = "serve",
               epoch_steps: int | None = None):
        """The serving runner over this plan: ``CNNRunner`` for a CNN plan,
        ``LMRunner`` for an LM plan (``EpochLMRunner`` with
        ``epoch_steps``)."""
        from repro_torch.core.plan import PlanError
        from repro_torch.launch.engine import CNNRunner, LMRunner

        if self.plan.kind != "lm":
            return CNNRunner(self.plan)
        if self.model is None:
            raise PlanError(
                "serving an LM plan needs its ArchConfig (cache geometry, "
                "vocab) — reload through api.build(cfg, ...).compile("
                "cache=...) or api.load(path, spec=cfg)")
        if epoch_steps is None:
            return LMRunner(None, self.model.spec, new_tokens=new_tokens,
                            qmode=qmode, model_plan=self.plan)
        from repro_torch.resilience import EpochLMRunner

        return EpochLMRunner(None, self.model.spec, new_tokens=new_tokens,
                             epoch_steps=epoch_steps, qmode=qmode,
                             model_plan=self.plan)

    def simulate(self, target: str = "sot_mram") -> CostReport:
        """Price this plan on one of the paper's PIM designs — the
        reference's arithmetic, float for float."""
        from repro_torch.core.plan import PlanError
        from repro_torch.pim.mapper import effective_bits, works_from_layers

        if self.plan.kind != "cnn":
            raise PlanError("simulate() prices CNN plans (the paper's "
                            f"scope); this plan is {self.plan.kind!r}")
        t = get_target(target)
        if not isinstance(t, PIMTarget):
            raise PlanError(f"simulate prices the PIM designs; {t.name!r} "
                            "is a compute target")
        layers = self.plan.layers
        r = t.report(works_from_layers(layers))
        per_layer = tuple(
            (lp.name, t.cost(LayerGeometry(lp.out_h * lp.out_w, lp.k,
                                           lp.cout), *effective_bits(lp)))
            for lp in layers)
        return CostReport(
            target=t.name, energy_uj=r["energy_uj"],
            latency_us=r["latency_us"], fps=r["fps"], macs=r["macs"],
            row_ops=r["row_ops"],
            bytes_moved=sum(c.bytes_moved for _, c in per_layer),
            layers=per_layer, area_mm2=r["area_mm2"],
            fps_per_mm2=r["fps_per_mm2"], gops_per_w=r["gops_per_w"],
            eff_per_mm2=r["eff_per_mm2"])

    def save(self, path: str) -> str:
        from repro_torch.core.plan import save_plan

        self.cache_path = save_plan(self.plan, path)
        return self.cache_path


def build(spec, quant: QuantConfig | None = None, *, params=None,
          img_hw=40, name: str | None = None) -> Model:
    """Open a session: ``spec`` is a ConvSpec list (CNN) or an ArchConfig
    (LM — its own ``quant`` is used unless overridden)."""
    if _is_lm(spec):
        q = quant if quant is not None else spec.quant
        cfg = spec if quant is None else dataclasses.replace(spec, quant=quant)
        return Model(spec=cfg, quant=q, params=params,
                     name=name or getattr(cfg, "name", "lm"))
    if quant is None:
        raise TypeError("build(spec, quant): CNN specs carry no quant "
                        "config of their own — pass one explicitly")
    return Model(spec=tuple(spec), quant=quant, params=params, img_hw=img_hw,
                 name=name or "cnn")


def load(path: str, *, spec=None, quant: QuantConfig | None = None,
         model: str | None = None, backend: str | None = None,
         device="cuda") -> CompiledModel:
    """Reload a persisted plan as a CompiledModel, its params on
    ``device``, optionally guarded against the caller's configuration
    (:func:`repro_torch.core.plan.check_plan_matches`)."""
    from repro_torch.core.plan import check_plan_matches, load_plan

    plan = check_plan_matches(load_plan(path, device=device), quant=quant,
                              model=model, backend=backend)
    m = None
    if spec is not None:
        m = build(spec, quant if quant is not None else plan.quant,
                  name=plan.model)
    return CompiledModel(plan, model=m, cache_path=path, reloaded=True)

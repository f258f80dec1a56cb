"""Session facade: build -> compile -> forward / serve / simulate (port of
the CNN half of ``repro/api/session.py``).

    model    = build(spec, quant, params=params)          # ConvSpec list
    compiled = model.compile(target="cuda", batch_hints=(1, 8))
    compiled.forward(x)                                   # one batch
    compiled.serve(max_batch=8).predict(images)           # request engine
    compiled.simulate(target="sot_mram")                  # PIM cost report

``simulate`` is pure arithmetic over the plan's geometry and gives the
reference's floats exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core.quant import QuantConfig
from .targets import LayerGeometry, PIMTarget, get_target


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


class Deployment:
    """A live serving handle over :class:`repro_torch.launch.engine.
    ServeEngine`."""

    def __init__(self, engine, compiled: "CompiledModel"):
        self.engine = engine
        self.compiled = compiled

    def predict(self, payloads) -> list[np.ndarray]:
        """Closed-loop serve: submit all payloads, drain, values in order."""
        return [r.value for r in self.engine.serve(list(payloads))]

    @property
    def stats(self) -> dict:
        return self.engine.stats


@dataclasses.dataclass
class Model:
    """An uncompiled CNN: spec + quantization + (optional) params."""

    spec: Any
    quant: QuantConfig
    params: Any = None
    img_hw: Any = 40

    def compile(self, *, target: str = "cuda",
                batch_hints=(1,)) -> "CompiledModel":
        """Compile against a compute target (``cuda``).  Params are
        pre-quantized on the device they live on."""
        from repro_torch.core import plan as P

        t = get_target(target)
        if t.kind != "compute":
            raise P.PlanError(
                f"target {target!r} is a simulated PIM design — compile "
                "against a compute target (cuda) and pass the PIM target "
                "to .simulate() instead")
        return CompiledModel(P.compile_model(
            self.params, self.spec, self.quant, target=t.name,
            batch_hints=batch_hints, img_hw=self.img_hw))


@dataclasses.dataclass
class CompiledModel:
    """A compiled ModelPlan with forward / serve / simulate attached."""

    plan: Any

    @property
    def params(self):
        return self.plan.params

    def forward(self, x, reference: bool = False):
        """One batched forward through the plan; ``x`` (B,H,W,C) on the
        params' device.  ``reference=True`` uses the kernels' plain
        versions (the on-device oracle)."""
        from repro_torch.core import plan as P

        return P.plan_forward(self.plan, x, reference=reference)

    def serve(self, *, max_batch: int = 8, flush_deadline_s: float = 0.005,
              max_pending: int = 4096) -> Deployment:
        """Stand up the request-level serving engine on this plan."""
        from repro_torch.launch.engine import CNNRunner, ServeEngine

        engine = ServeEngine(CNNRunner(self.plan), max_batch=max_batch,
                             flush_deadline_s=flush_deadline_s,
                             max_pending=max_pending)
        return Deployment(engine, self)

    def simulate(self, target: str = "sot_mram") -> CostReport:
        """Price this plan on one of the paper's PIM designs — the
        reference's arithmetic, float for float."""
        from repro_torch.core.plan import PlanError
        from repro_torch.pim.mapper import effective_bits, works_from_layers

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


def build(spec, quant: QuantConfig, *, params=None, img_hw=40) -> Model:
    """Open a session on a CNN ``spec`` (ConvSpec list)."""
    return Model(spec=tuple(spec), quant=quant, params=params, img_hw=img_hw)

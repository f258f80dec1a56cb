"""The paper's tables on the target registry (port of
``repro/api/reports.py``, §III-C/D/E).

Calibration protocol, as in the reference: the cycle structure of each
design is derived from its dataflow, never fitted; one energy scale per
design is fitted to the ImageNet column of Table II (it lives on the
:class:`~repro_torch.api.targets.PIMTarget` instances); the SVHN and
MNIST columns and the Fig. 9/10 ratios are then predictions of the model.

Every function compiles a structure-only plan (``params=None``, target
``cuda``: no tensor is made and no device is touched) for the dataset's
CNN and prices it on a PIM target — ``simulate(design, dataset)`` is
``build(spec, quant).compile(target="cuda").simulate(target=design)``.
The numbers are the reference's, float for float: pricing reads only the
plan's geometry and bit widths, which do not depend on the compute
target.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.models.cnn import ConvSpec, alexnet_spec, svhn_cnn_spec
from repro_torch.pim.energy import TABLE2_ENERGY_SCALE as ENERGY_SCALE
from .targets import get_target

# Table II (paper): energy uJ/img and area mm2 per design per dataset.
TABLE2 = {
    "reram":    dict(imagenet=(2275.34, 9.19), svhn=(425.21, 0.085), mnist=(13.55, 0.060)),
    "imce":     dict(imagenet=(785.25, 2.12),  svhn=(135.26, 0.010), mnist=(0.92, 0.009)),
    "proposed": dict(imagenet=(471.8, 2.60),   svhn=(84.31, 0.039),  mnist=(0.68, 0.012)),
}

# Headline claims (abstract / §III-C,D).
CLAIMS = dict(
    imce=dict(energy=2.1, speed=3.0),
    reram=dict(energy=5.4, speed=9.0),
    asic=dict(energy=9.7, speed=13.5),
)


def lenet_spec() -> list[ConvSpec]:
    """LeNet-5-style MNIST model for the Table II MNIST column."""
    return [
        ConvSpec(1, 6, 5, role="first"),
        ConvSpec(6, 16, 5, pool=True),
        ConvSpec(16, 120, 5, pool=True, fc=True),
        ConvSpec(120, 84, 1, fc=True),
        ConvSpec(84, 10, 1, fc=True, role="last"),
    ]


# Table II's SVHN BCNN is larger than the accuracy model (the paper reuses
# the BCNN of its reference [8] for the energy rows)
TABLE2_SVHN_CHANNELS = 72

DATASETS = {
    "imagenet": dict(spec=alexnet_spec, img=224),
    "svhn": dict(spec=lambda: svhn_cnn_spec(TABLE2_SVHN_CHANNELS), img=40),
    "mnist": dict(spec=lenet_spec, img=28),
}


@functools.lru_cache(maxsize=64)
def _dataset_compiled(dataset: str, m_bits: int, n_bits: int):
    """Structure-only compiled session for one dataset at one W:I config
    (every design prices the same plan)."""
    from repro_torch.core.quant import QuantConfig
    from .session import build

    ds = DATASETS[dataset]
    quant = QuantConfig(w_bits=n_bits, a_bits=m_bits, g_bits=8)
    model = build(ds["spec"](), quant, img_hw=ds["img"], name=dataset)
    return model.compile(target="cuda")


def simulate(design: str, dataset: str, m_bits: int = 1,
             n_bits: int = 1) -> dict:
    """Energy/latency/area row for one design on one dataset."""
    report = _dataset_compiled(dataset, m_bits, n_bits).simulate(
        target=design)
    return dict(
        energy_uj=report.energy_uj, latency_us=report.latency_us,
        fps=report.fps, macs=report.macs, row_ops=report.row_ops,
        area_mm2=report.area_mm2, fps_per_mm2=report.fps_per_mm2,
        gops_per_w=report.gops_per_w, eff_per_mm2=report.eff_per_mm2)


def table2(m_bits: int = 1, n_bits: int = 1) -> dict:
    """Table II: energy/area per design per dataset (BCNN 1:1)."""
    out = {}
    for design in ("reram", "imce", "proposed"):
        area = get_target(design).area_mm2
        out[design] = {
            ds: dict(energy_uj=simulate(design, ds, m_bits,
                                        n_bits)["energy_uj"],
                     area_mm2=area)
            for ds in DATASETS
        }
    return out


def _gmean(xs) -> float:
    return float(np.exp(np.mean(np.log(xs))))


def fig9_fig10(configs=((1, 1), (1, 4), (1, 8), (2, 2))) -> dict:
    """Area-normalized energy efficiency (Fig. 9) and fps (Fig. 10) across
    W:I configs, averaged over datasets, ratios vs the proposed design."""
    designs = ("proposed", "imce", "reram", "asic")
    effs: dict[str, list] = {k: [] for k in designs}
    fpss: dict[str, list] = {k: [] for k in designs}
    for (n_b, m_b) in configs:  # (W, I)
        for ds in DATASETS:
            for design in designs:
                r = simulate(design, ds, m_b, n_b)
                effs[design].append(r["eff_per_mm2"])
                fpss[design].append(r["fps_per_mm2"])
    eff = {k: _gmean(v) for k, v in effs.items()}
    fps = {k: _gmean(v) for k, v in fpss.items()}
    return dict(
        eff_per_mm2=eff, fps_per_mm2=fps,
        energy_ratio={k: eff["proposed"] / eff[k] for k in designs
                      if k != "proposed"},
        speed_ratio={k: fps["proposed"] / fps[k] for k in designs
                     if k != "proposed"},
    )


def paper_claims(dataset: str = "imagenet", m_bits: int = 1,
                 n_bits: int = 1) -> list[dict]:
    """ONE compiled plan priced on every PIM target: the proposed design's
    energy/speed ratios over each rival beside the paper's claims."""
    compiled = _dataset_compiled(dataset, m_bits, n_bits)
    proposed = compiled.simulate(target="sot_mram")
    rows = []
    for rival, legacy in (("imce", "imce"), ("reram", "reram"),
                          ("cmos_asic", "asic")):
        r = compiled.simulate(target=rival)
        ratios = proposed.vs(r)
        rows.append(dict(
            name=f"claim_vs_{legacy}", dataset=dataset,
            fingerprint=compiled.fingerprint(),
            energy_ratio=round(ratios["energy"], 2),
            speed_ratio=round(ratios["speed"], 2),
            # the paper's headline form is area-normalized (Fig. 9/10)
            energy_ratio_per_mm2=round(
                proposed.eff_per_mm2 / r.eff_per_mm2, 2),
            speed_ratio_per_mm2=round(
                proposed.fps_per_mm2 / r.fps_per_mm2, 2),
            paper_energy_claim=CLAIMS[legacy]["energy"],
            paper_speed_claim=CLAIMS[legacy]["speed"]))
    return rows


def calibrate() -> dict[str, float]:
    """Refit the per-design energy scale to the Table II ImageNet column
    (the pinned values live on the PIMTarget instances)."""
    from repro_torch.pim.mapper import accel_cost, works_from_layers

    works = works_from_layers(_dataset_compiled("imagenet", 1, 1).plan.layers)
    scales = {}
    for design in ("proposed", "imce", "reram"):
        raw = accel_cost(get_target(design).device, works)["energy_uj"]
        scales[design] = TABLE2[design]["imagenet"][0] / raw
    scales["asic"] = ENERGY_SCALE["asic"]
    return scales

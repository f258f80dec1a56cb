"""Plan prover: static bit-range verification of a compiled ModelPlan
(port of ``repro/analysis/prover.py``).

:func:`verify_plan` runs interval abstract interpretation (see
:mod:`repro_torch.analysis.intervals`) over every (layer x batch_hint x
engine) row of a :class:`repro_torch.core.plan.ModelPlan` and proves,
ahead of the first dispatch, the contracts the port's kernels assume.  The
rule IDs and their messages are the reference's; each bound is the one the
Hopper kernel's wrapper (and its plain version) enforces, through the
port's own predicates:

* **PV101** — every float-unit integer dot fits the fp32 mantissa:
  ``f32dot`` (an fp32 matmul with TF32 off, ``and_accum.f32dot_exact``)
  and the flash engine's centred-level score dot
  (``attn_flash.flash_levels_exact``, its plain version's float matmul).
  The port's ``implicit`` has no float group product: it accumulates u8
  products in int32 on the card (float64 in its plain version), so it
  falls under PV102.
* **PV102** — int32 accumulator, rowsum and zero-point-correction
  magnitudes cannot overflow on the integer-accumulating engines
  (``and_accum.int32_exact``; ``implicit`` and ``depthwise`` on every
  target, the latter over its 9 taps; ``faithful``
  over K rounded up to whole 32-bit words; the ``int8`` engines' s8 x s8
  partial sums, ``bitgemm_mxu.int8_exact``).
* **PV103** — every serialized engine verdict is feasible per
  ``ops.engine_feasible`` / ``ops.attn_engine_feasible``: uint8 operands,
  ``conv_implicit``'s shared-memory layout, ``dwconv``'s own limits (a
  depthwise layer on ``depthwise`` alone: 3x3, stride 1 or 2, SAME,
  channels in whole 4-byte vectors), the attention kernels' head dims.
* **PV104** — dispatch-table completeness/consistency: every dense row has
  its ``dense_plan_key`` entry (and agrees with it), every attention row
  its ``attn_table`` verdict, no orphan table entries.
* **PV105** — cost-annotation sanity: finite, non-negative, and strictly
  positive energy/cycles on quantized rows.
* **PV106** — serialization invariants: plan metadata survives a JSON
  round trip with an identical fingerprint (and, for
  :func:`verify_plan_file`, the on-disk metadata IS the reloaded plan's).
* **PV107** — structural invariants: version, batch hints, per-layer
  engine tables, conv GEMM-depth consistency.
* **PV108** — paged-attention feasibility: every paged verdict (10-tuple
  key, see ``ops.attn_plan_key``) proves its page geometry via
  ``ops.paged_attn_bounds`` at the plan's largest batch hint: the page
  size tiles the table extent, the flat KV index stays in int32, and one
  ``csrc/attn_paged.cu`` block fits the card's shared memory (the
  reference's bound is a TPU VMEM budget).

The bounds are the kernels' on every target: on the CPU the wrappers run
the plain versions, which compute the same integers, so a ``target``
override changes which compute target states the bounds (any name
without one of its own gets ``cuda``'s), never the rules.

Wired into ``compile_model`` / ``compile_lm`` and ``Model.compile`` (on by
default, ``verify=False`` escape hatch) and the ``python -m
repro_torch.analysis check-plan`` CLI for saved artifacts.  Pure Python
over the plan's metadata: no tensor, no device work.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

from repro_torch.analysis.intervals import (FP32_MANTISSA, INT32_MAX,
                                            Interval, centered_range,
                                            dot_range, level_range)
from repro_torch.core.plan import PlanError

# Engines that accumulate integer products in an int32 register (directly
# or as shifted partials summing to the same total): every engine of the
# port's kernels but f32dot
_INT_ACC_ENGINES = frozenset(
    {"int8", "int8_planewise", "fused", "faithful", "planes", "packed",
     "implicit", "depthwise"})

# The attention path quantizes q/k at 8 bits regardless of QuantConfig
# (kernels/attn_flash.attn_quant_scale); the prover mirrors that constant.
_ATTN_BITS = 8


@dataclasses.dataclass(frozen=True)
class Violation:
    """One failed proof obligation."""

    rule: str       # "PV101".."PV108"
    where: str      # plan coordinates: layer/batch/engine or table key
    message: str

    def __str__(self) -> str:
        return f"{self.rule} [{self.where}] {self.message}"


class PlanVerificationError(PlanError):
    """A compiled or reloaded plan failed static verification.

    Subclasses :class:`repro_torch.core.plan.PlanError` so every existing
    ``except PlanError`` call site catches prover rejections too.
    """

    def __init__(self, violations):
        self.violations = tuple(violations)
        lines = "\n".join(f"  {v}" for v in self.violations)
        super().__init__(
            f"plan failed static verification "
            f"({len(self.violations)} violation(s)):\n{lines}\n"
            "(recompile the plan, or pass verify=False to bypass "
            "at your own risk)")


def _check_exactness(lp, engine: str, where: str, out) -> None:
    """PV101/PV102 for one (layer, batch_hint, engine) row."""
    from repro_torch.core import bitplane
    from repro_torch.core.and_accum import f32dot_exact, int32_exact
    from repro_torch.kernels.attn_flash import flash_levels_exact
    from repro_torch.kernels.bitgemm_mxu import int8_exact

    a, w, k = level_range(lp.a_bits), level_range(lp.w_bits), lp.k
    if lp.op == "attn":
        if lp.fp:
            return
        if engine == "flash" and not flash_levels_exact(k, _ATTN_BITS,
                                                        _ATTN_BITS):
            lv = centered_range(_ATTN_BITS)
            acc = dot_range(lv, lv, k)
            out.append(Violation(
                "PV101", where,
                f"flash centered-level score dot reaches |{acc.mag}| at "
                f"head_dim={k} — exceeds the fp32 mantissa "
                f"(2^24 = {FP32_MANTISSA}); the attn_flash runtime "
                "guard would raise on the first call"))
        # rowsum-corrected integer form: acc - z_k*rs_q - z_q*rs_k
        # + hd*z_q*z_k with unsigned 8-bit levels and z = 2^7
        ulv = level_range(_ATTN_BITS)
        z = Interval(1 << (_ATTN_BITS - 1), 1 << (_ATTN_BITS - 1))
        rs = ulv.scale(k)
        corr = dot_range(ulv, ulv, k) - z * rs - z * rs + (z * z).scale(k)
        if corr.mag > INT32_MAX:
            out.append(Violation(
                "PV102", where,
                f"attention zero-point correction reaches |{corr.mag}| at "
                f"head_dim={k} — overflows int32"))
        return
    if engine in ("fp", ""):
        return
    if engine == "f32dot" and not f32dot_exact(k, lp.a_bits, lp.w_bits):
        out.append(Violation(
            "PV101", where,
            f"f32dot accumulator reaches {dot_range(a, w, k).hi} at K={k}, "
            f"a_bits={lp.a_bits}, w_bits={lp.w_bits} — exceeds the "
            f"fp32 mantissa (2^24 = {FP32_MANTISSA}); the "
            "bitgemm_f32dot runtime guard would raise on the first "
            "call"))
    if engine not in _INT_ACC_ENGINES:
        return
    # the faithful kernel sums whole 32-bit words of K (zero padded)
    kk = -(-k // bitplane.LANE) * bitplane.LANE if engine == "faithful" else k
    if not int32_exact(kk, lp.a_bits, lp.w_bits):
        out.append(Violation(
            "PV102", where,
            f"integer accumulator reaches {dot_range(a, w, kk).hi} at "
            f"K={kk}, a_bits={lp.a_bits}, w_bits={lp.w_bits} — overflows "
            "int32"))
    rowsum = a.scale(kk)
    if rowsum.mag > INT32_MAX:
        out.append(Violation(
            "PV102", where,
            f"activation rowsum reaches {rowsum.hi} at K={kk}, "
            f"a_bits={lp.a_bits} — the dequant epilogue's int32 "
            "rowsum overflows"))
    if engine in ("int8", "int8_planewise") and not int8_exact(k):
        s8 = centered_range(_ATTN_BITS)
        out.append(Violation(
            "PV102", where,
            f"s8 x s8 partial sum reaches {dot_range(s8, s8, k).hi} at "
            f"K={k} — the int8_matmul kernel's int32 accumulator "
            "overflows"))


def _check_feasibility(lp, batch: int, engine: str, bounds: str, where: str,
                       backend: str, out) -> None:
    """PV103 for one (layer, batch_hint, engine) row."""
    from repro_torch.kernels import ops

    if engine == "fp" or lp.op == "attn":
        return  # attention verdicts are checked through the attn_table
    conv = None
    m = batch
    if lp.op == "conv":
        conv = ops.ConvShape(lp.in_h, lp.in_w, lp.kh, lp.kw, lp.stride,
                             lp.padding, batch=batch, groups=lp.groups)
        m = conv.m
    ok, reason = ops.engine_feasible(engine, m, lp.k, lp.cout, lp.a_bits,
                                     lp.w_bits, bounds, conv)
    if not ok:
        out.append(Violation(
            "PV103", where,
            f"serialized engine {engine!r} is infeasible on backend "
            f"{backend!r}: {reason}"))


def _attn_shape(key: tuple):
    """The AttnShape an ``attn_plan_key`` stands for (contiguous keys are
    8-tuples; paged keys append ``(page_size, seq_kv)``)."""
    from repro_torch.kernels import ops

    paged = len(key) == 10
    return ops.AttnShape(
        seq_q=int(key[1]), seq_kv=int(key[9]) if paged else int(key[1]),
        heads=int(key[2]), head_dim=int(key[3]), causal=bool(key[4]),
        window=int(key[5]) or None, quantized=bool(key[6]),
        page_size=int(key[8]) if paged else None)


def _check_tables(plan, out) -> None:
    """PV104 (+ attention PV103 and PV108): dispatch-table completeness.
    Table keys carry the plan's own backend."""
    from repro_torch.core.plan import SIGNED_ENGINES
    from repro_torch.kernels import ops

    if plan.kind != "lm":
        return
    dense_rows = [lp for lp in plan.layers if lp.op == "dense"]
    attn_rows = [lp for lp in plan.layers if lp.op == "attn"]
    seen_dense = set()
    for lp in dense_rows:
        key = ops.dense_plan_key(lp.k, lp.cout, lp.a_bits, lp.w_bits,
                                 plan.backend)
        seen_dense.add(key)
        where = f"layer {lp.index} ({lp.name})"
        if key not in plan.dense_table:
            out.append(Violation(
                "PV104", where,
                f"dense row has no dense_table entry for key {key!r} — "
                "select_engine would fall through to the heuristic at "
                "serve time"))
        elif plan.dense_table[key] != lp.engine:
            out.append(Violation(
                "PV104", where,
                f"dense row pins engine {lp.engine!r} but the dispatch "
                f"table installs {plan.dense_table[key]!r} for its key"))
    for key, eng in sorted(plan.dense_table.items()):
        where = f"dense_table[{key!r}]"
        if eng not in SIGNED_ENGINES:
            out.append(Violation(
                "PV104", where,
                f"table engine {eng!r} is not in the signed serve set "
                f"{SIGNED_ENGINES}"))
        if tuple(key) not in seen_dense:
            out.append(Violation(
                "PV104", where,
                "orphan dense_table entry (no layer row produces this "
                "key)"))
    if len(attn_rows) != len(plan.attn_table):
        out.append(Violation(
            "PV104", "attn_table",
            f"{len(attn_rows)} attention row(s) but "
            f"{len(plan.attn_table)} attn_table verdict(s) — a missing "
            "row dispatches off-plan at serve time"))
    table_engines = set(plan.attn_table.values())
    for lp in attn_rows:
        where = f"layer {lp.index} ({lp.name})"
        if not lp.attn_engine or lp.attn_engine != lp.engine:
            out.append(Violation(
                "PV107", where,
                f"attention row engine {lp.engine!r} does not match its "
                f"attn_engine record {lp.attn_engine!r}"))
        elif lp.engine not in table_engines:
            out.append(Violation(
                "PV104", where,
                f"attention row pins {lp.engine!r} but no attn_table "
                "verdict installs it"))
    for key, eng in sorted(plan.attn_table.items()):
        where = f"attn_table[{key!r}]"
        if len(key) not in (8, 10) or key[0] != "attn":
            out.append(Violation("PV104", where, "malformed attn_plan_key"))
            continue
        if eng not in ops.ATTN_ENGINES:
            out.append(Violation(
                "PV104", where,
                f"unknown attention engine {eng!r} "
                f"(expected one of {ops.ATTN_ENGINES})"))
            continue
        attn = _attn_shape(key)
        ok, reason = ops.attn_engine_feasible(eng, attn)
        if not ok:
            out.append(Violation(
                "PV103", where,
                f"attention verdict {eng!r} is infeasible: {reason}"))
        if len(key) == 10:
            # PV108: the page-indexed gather must be provably addressable
            # (int32 flat index at the plan's largest batch hint) and one
            # attn_paged block must fit shared memory — an engine built on
            # this plan never discovers an overflowing page table at serve
            # time
            ok, reason = ops.paged_attn_bounds(attn,
                                               batch=max(plan.batch_hints))
            if not ok:
                out.append(Violation(
                    "PV108", where,
                    f"paged-attention geometry infeasible: {reason}"))


def _check_cost(lp, where: str, out) -> None:
    """PV105 for one layer row."""
    cost = tuple(lp.cost or ())
    if not cost:
        if not lp.fp:
            out.append(Violation(
                "PV105", where,
                "quantized row carries no cost annotation (plan compiled "
                "outside _annotate_costs?)"))
        return
    if len(cost) != 3:
        out.append(Violation(
            "PV105", where,
            f"cost annotation has {len(cost)} field(s), expected "
            "(energy_pj, cycles, bytes_moved)"))
        return
    energy, cycles, bytes_moved = (float(c) for c in cost)
    for name, v in (("energy_pj", energy), ("cycles", cycles),
                    ("bytes_moved", bytes_moved)):
        if not math.isfinite(v) or v < 0:
            out.append(Violation(
                "PV105", where, f"cost {name}={v!r} is not a finite "
                "non-negative number"))
            return
    if not lp.fp and (energy <= 0 or cycles <= 0):
        out.append(Violation(
            "PV105", where,
            f"quantized row annotated with energy_pj={energy}, "
            f"cycles={cycles} — zero/negative cost would corrupt the "
            "resilience energy budget and every simulate() report"))


def _check_structure(plan, out) -> None:
    """PV107 plus the PV106 metadata round-trip invariant."""
    from repro_torch.core import plan as P

    if plan.version != P.PLAN_VERSION:
        out.append(Violation(
            "PV107", "plan",
            f"version {plan.version!r} != PLAN_VERSION {P.PLAN_VERSION}"))
    hints = tuple(plan.batch_hints)
    if not hints or any((not isinstance(b, int)) or b < 1 for b in hints):
        out.append(Violation(
            "PV107", "plan",
            f"batch_hints {hints!r} must be non-empty positive ints"))
    elif len(set(hints)) != len(hints):
        out.append(Violation(
            "PV107", "plan", f"duplicate batch_hints {hints!r}"))
    for lp in plan.layers:
        where = f"layer {lp.index} ({lp.name})"
        if lp.op not in ("conv", "dense", "attn"):
            out.append(Violation("PV107", where,
                                 f"unknown layer op {lp.op!r}"))
            continue
        row_hints = tuple(b for b, _ in lp.engines)
        if set(row_hints) != set(hints):
            out.append(Violation(
                "PV107", where,
                f"engine table covers batch hints {row_hints!r}, plan "
                f"declares {hints!r}"))
        elif lp.engine != dict(lp.engines)[row_hints[0]]:
            out.append(Violation(
                "PV107", where,
                f"primary engine {lp.engine!r} disagrees with the engine "
                f"table entry at hint {row_hints[0]}"))
        if lp.op == "conv":
            if lp.fp != (lp.engine == "fp"):
                out.append(Violation(
                    "PV107", where,
                    f"fp={lp.fp} inconsistent with engine {lp.engine!r}"))
            if lp.k != lp.kh * lp.kw * lp.cin:
                out.append(Violation(
                    "PV107", where,
                    f"GEMM depth k={lp.k} != kh*kw*cin = "
                    f"{lp.kh * lp.kw * lp.cin}"))
            if lp.out_h < 1 or lp.out_w < 1:
                out.append(Violation(
                    "PV107", where,
                    f"degenerate output extent {lp.out_h}x{lp.out_w}"))
        if not lp.fp and not (1 <= lp.a_bits <= 32 and 1 <= lp.w_bits <= 32):
            out.append(Violation(
                "PV107", where,
                f"bit widths a_bits={lp.a_bits}, w_bits={lp.w_bits} out "
                "of range [1, 32]"))
    # PV106: metadata must survive a JSON round trip fingerprint-identically
    # (the fingerprint is the serve engine's program-cache key — drift here
    # means a reloaded plan silently misses every compiled program).
    try:
        meta = json.loads(json.dumps(plan.meta(), sort_keys=True))
        rebuilt = P.ModelPlan(
            kind=meta["kind"], model=meta["model"], backend=meta["backend"],
            quant=P.QuantConfig(**meta["quant"]),
            batch_hints=tuple(meta["batch_hints"]),
            layers=tuple(P._layer_from_json(d) for d in meta["layers"]),
            dense_table={tuple(k): v for k, v in meta["dense_table"]},
            attn_table={tuple(k): v for k, v in meta["attn_table"]},
            autotune={tuple(k): (e, t) for k, e, t in meta["autotune"]},
            version=meta["version"])
        if rebuilt.fingerprint() != plan.fingerprint():
            out.append(Violation(
                "PV106", "plan",
                "metadata does not survive a JSON round trip: rebuilt "
                f"fingerprint {rebuilt.fingerprint()} != "
                f"{plan.fingerprint()}"))
    except Exception as e:  # repro-lint: disable=RL003 — recorded as PV106
        out.append(Violation(
            "PV106", "plan",
            f"metadata round trip failed: {type(e).__name__}: {e}"))


def verify_plan(plan, target: str | None = None) -> list[Violation]:
    """Statically verify a compiled plan; returns all violations found.

    ``target`` overrides the backend the proofs are stated against
    (default: the plan's own ``backend``); its bounds are its compute
    target's (``api.targets.target_for_backend``).  Empty list ==
    verified."""
    from repro_torch.api.targets import target_for_backend

    backend = target or plan.backend
    bounds = target_for_backend(backend).name
    out: list[Violation] = []
    _check_structure(plan, out)
    for lp in plan.layers:
        _check_cost(lp, f"layer {lp.index} ({lp.name})", out)
        if lp.fp and lp.op != "attn":
            continue
        for b, eng in lp.engines:
            where = (f"layer {lp.index} ({lp.name}) batch={b} "
                     f"engine={eng}")
            _check_exactness(lp, eng, where, out)
            _check_feasibility(lp, b, eng, bounds, where, backend, out)
    _check_tables(plan, out)
    return out


def assert_plan_verified(plan, target: str | None = None) -> None:
    """Raise :class:`PlanVerificationError` unless the plan proves clean."""
    violations = verify_plan(plan, target)
    if violations:
        raise PlanVerificationError(violations)


def verify_plan_file(path: str, target: str | None = None,
                     device="cpu") -> list[Violation]:
    """Verify a serialized plan artifact (``<base>.json`` [+ ``.npz``]),
    reloaded with its params on ``device``.

    Adds the on-disk PV106 obligation: the file's metadata (params payload
    keys aside) must be exactly what the reloaded plan re-serializes to —
    a hand-edited or version-drifted artifact fails here instead of
    serving with a wrong program-cache identity.
    """
    from repro_torch.core.plan import _plan_base, load_plan

    base = _plan_base(os.fspath(path))
    plan = load_plan(base, device=device)
    out = verify_plan(plan, target)
    with open(base + ".json") as f:
        ondisk = json.load(f)
    ondisk.pop("params_skel", None)
    ondisk.pop("params_npz", None)
    if (json.dumps(ondisk, sort_keys=True)
            != json.dumps(plan.meta(), sort_keys=True)):
        out.append(Violation(
            "PV106", base + ".json",
            "on-disk metadata differs from the reloaded plan's "
            "re-serialization (hand-edited or drifted artifact)"))
    return out

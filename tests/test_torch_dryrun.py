"""The port's dry-run tooling held against the reference on the CPU:
``configs`` (``all_configs``, ``SHAPES``, ``shapes()``, the analysis
toggles), ``launch.hlo_analysis`` (the config arithmetic equal as floats,
``collective_stats`` on HLO text, the step counter), ``launch.steps
.build_cell``, ``launch.dryrun.run_cell`` on the fake 16 x 16 mesh and
``launch.sweep``.

The dry-run cells run the reference's smoke geometry (``SMOKE``) on the
production mesh at reduced shapes (``CELLS``: the cell's kind, 64
positions, batch 32).  The smoke heads (4 query, 2 KV) do not divide the
16-way ``model`` axis: ``sharding.tree_shardings`` replicates what does
not divide (the reference's rule), and the query heads are padded to 16
(``ShardPlan.padded_heads``); the RWKV-6 cell takes 16 heads of 8
(``rwkv_head_dim=8``), as its production config's 32 heads divide the
axis, because its time mix splits the heads dim of the model-split
projections.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.launch import hlo_analysis as jha  # noqa: E402
from repro.launch import sweep as jsweep  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs import SHAPES, ShapeCell  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.launch import dryrun, steps, sweep  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

from test_torch_train_cnn import one_torch_thread  # noqa: E402,F401

ARCHS = list(configs.ARCH_IDS)
RESULT_KEYS = {"arch", "shape", "mesh", "chips", "ok", "lower_s", "compile_s",
               "memory", "collectives", "roofline", "flops", "bytes_accessed"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes"}
# the smoke fields of the reference's ArchConfig.smoke (widths and depth)
SMOKE = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "head_dim",
         "vocab", "n_experts", "top_k", "expert_d_ff", "n_shared_experts",
         "lru_width", "n_patches", "vit_dim", "frame_dim", "lora_rank",
         "window", "remat")
CELLS = {"train_4k": 64, "prefill_32k": 64, "decode_32k": 64}


def smoke_overrides(arch: str, **extra) -> dict:
    s = configs.get_config(arch).smoke()
    return {**{f: getattr(s, f) for f in SMOKE}, **extra}


@pytest.fixture
def small_cells(monkeypatch):
    """The shape cells at 64 positions and batch 32 (same kinds)."""
    for name, seq in CELLS.items():
        c = SHAPES[name]
        monkeypatch.setitem(SHAPES, name, ShapeCell(name, c.kind, seq, 32))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_toggles_equal_reference(arch):
    got, ref = configs.get_config(arch), jconfigs.get_config(arch)
    assert [c.name for c in got.shapes()] == [c.name for c in ref.shapes()]
    assert got.skip_shapes == ref.skip_shapes
    for f in ("scan_layers", "full_attn_analysis", "rglru_assoc",
              "remat_prevent_cse", "act_scale", "constrain_acts"):
        assert getattr(got, f) == getattr(ref, f), f
    assert set(configs.all_configs()) == set(jconfigs.all_configs())
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


def test_sweep_cells_equal_reference():
    assert sweep.cell_list() == jsweep.cell_list()


# ---------------------------------------------------------------------------
# hlo_analysis: the config arithmetic, the HLO parser, the roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    got, ref = configs.get_config(arch), jconfigs.get_config(arch)
    assert ha.active_param_count(got) == jha.active_param_count(ref)
    for name in SHAPES:
        cell, jcell = SHAPES[name], jconfigs.SHAPES[name]
        assert ha.model_flops_estimate(got, cell) \
            == jha.model_flops_estimate(ref, jcell)
        assert ha.recurrence_flops_correction(got, cell) \
            == jha.recurrence_flops_correction(ref, jcell)


HLO = """\
HloModule m
ENTRY %main (p0: bf16[256,4096], p1: f32[8], p2: s8[16,32]) -> f32[8] {
  %p0 = bf16[256,4096]{1,0} parameter(0)
  %p1 = f32[8]{0} parameter(1)
  %p2 = s8[16,32]{1,0} parameter(2)
  %ag = bf16[4096,4096]{1,0} all-gather(bf16[256,4096]{1,0} %p0), dimensions={0}
  %ar = (f32[8]{0}, s8[16,32]{1,0}) all-reduce(f32[8]{0} %p1, s8[16,32]{1,0} %p2), to_apply=%add
  %rs = f32[1]{0} reduce-scatter(f32[8]{0} %p1), dimensions={0}
  %a2a = s8[16,32]{1,0} all-to-all(s8[16,32]{1,0} %p2), dimensions={0}
  %cps = (bf16[256,4096]{1,0}, u32[]) collective-permute-start(bf16[256,4096]{1,0} %p0)
  %ags = (f32[8]{0}, f32[64]{0}) all-gather-start(f32[8]{0} %p1)
  ROOT %out = f32[8]{0} add(f32[8]{0} %p1, f32[8]{0} %p1)
}
"""


def test_collective_stats_equals_reference():
    got, ref = ha.collective_stats(HLO), jha.collective_stats(HLO)
    assert got == ref
    assert got["counts"] == {"all-gather": 2, "all-reduce": 1,
                             "reduce-scatter": 1, "all-to-all": 1,
                             "collective-permute": 1}
    assert got["bytes_by_kind"]["all-reduce"] == 8 * 4 + 16 * 32


def test_roofline_keys_equal_reference_at_h100_peaks():
    kw = dict(hlo_flops=2e12, hlo_bytes=3e10, collective_bytes=4e8,
              chips=256, model_flops=1e14)
    got, ref = ha.Roofline(**kw).to_dict(), jha.Roofline(**kw).to_dict()
    assert list(got) == list(ref)
    assert got["compute_s"] == 2e12 / 989e12
    assert got["memory_s"] == 3e10 / 3.35e12
    assert got["collective_s"] == 4e8 / 450e9


# ---------------------------------------------------------------------------
# the step counter
# ---------------------------------------------------------------------------

def test_counter_counts_int_mm_and_each_kernel_by_its_plain_work():
    """``torch._int_mm`` counts 2·M·N·K; a kernel wrapper counts its
    formula once, hiding the plain version's ops, and the formula equals
    what the plain version's products count when they are not hidden."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import attn_flash as fl

    a = torch.zeros((24, 64), dtype=torch.int8)
    b = torch.zeros((64, 32), dtype=torch.int8)
    assert ha.step_flops(torch._int_mm, a, b) == 2.0 * 24 * 64 * 32
    q = torch.randn(1, 96, 2, 32)
    for kw in (dict(causal=True, window=None), dict(causal=True, window=40),
               dict(causal=False, window=None)):
        with ha.StepCounter() as c:
            fl.attn_flash(q, q, q, **kw)
        plain = ha.step_flops(fl.attn_flash_plain, q, q, q, block_q=32,
                              block_kv=32, **kw)
        assert c.kernel_calls == {"attn_flash": 1}
        assert c.flops == c.kernel_flops["attn_flash"] \
            == fl._flash_flops(q, q, q, **kw)
        assert plain == fl._flash_flops(q, q, q, block_q=32, block_kv=32,
                                        **kw)
    assert _lib.COUNTER[0] is None


def test_rwkv_recurrence_terms_counted_once():
    """The WKV scan's read-out einsum is the counter's part of the
    reference's recurrence correction (2·H·K·V a token, forward; 6 with
    its backward products), and ``recurrence_flops_uncounted`` is the
    rest, so counted + uncounted = the reference's count."""
    cfg = configs.get_config("rwkv6-1.6b").smoke(n_layers=1)
    B, S, H, K = 2, 8, cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    g = torch.Generator().manual_seed(0)
    r, k, w = (torch.rand(B, S, H, K, generator=g) for _ in range(3))
    v = torch.rand(B, S, H, K, generator=g)
    u, s0 = torch.rand(H, K, generator=g), torch.zeros(B, H, K, K)
    fwd = ha.step_flops(rwkv6._wkv_scan, r, k, v, w, u, s0)
    r.requires_grad_()
    s0.requires_grad_()
    train = ha.step_flops(lambda: torch.autograd.grad(
        rwkv6._wkv_scan(r, k, v, w, u, s0)[0].sum(), (r, s0)))
    for kind, counted in (("prefill", fwd), ("train", train)):
        cell = ShapeCell("c", kind, S, B)
        assert counted == 2.0 * B * S * H * K * K * (3 if kind == "train"
                                                     else 1)
        assert counted + ha.recurrence_flops_uncounted(cfg, cell) \
            == jha.recurrence_flops_correction(cfg, cell)


def test_analysis_prefill_counts_the_model_and_full_attention():
    """A dense smoke prefill with the analysis toggles on one device:
    every projection is a float product (the fp config), so the counted
    flops are 2·N_active·tokens (the reference's model count: q/k/v/o,
    the MLP, the tied unembed) plus the materialized attention
    (``full_attn_analysis``): QKᵀ and P·V over all S x S pairs of every
    query head, 4·B·H·S²·hd a layer.  Norms, RoPE, softmax and the
    residuals are elementwise: 0."""
    cfg = dataclasses.replace(
        configs.get_config("smollm-360m").smoke(), scan_layers=False,
        full_attn_analysis=True, rglru_assoc=True)
    cell = ShapeCell("p", "prefill", 64, 2)
    built = steps.build_cell(cfg, cell, configs.SINGLE, None)
    assert built["in_shardings"] == (None, None)
    assert built["donate_argnums"] == ()
    flops = ha.step_flops(built["fn"], *built["args"])
    tokens = cell.global_batch * cell.seq_len
    attn = (4.0 * cell.global_batch * cfg.n_heads * cell.seq_len ** 2
            * cfg.hd * cfg.n_layers)
    assert flops == ha.model_flops_estimate(cfg, cell) + attn
    assert ha.model_flops_estimate(cfg, cell) == \
        2.0 * ha.active_param_count(cfg) * tokens


# ---------------------------------------------------------------------------
# dryrun.run_cell on the fake production mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,extra", [
    ("smollm-360m", "train_4k", {}),
    ("rwkv6-1.6b", "prefill_32k", {"rwkv_head_dim": 8}),
    ("recurrentgemma-9b", "decode_32k", {}),
])
def test_run_cell_on_fake_mesh(arch, shape, extra, small_cells):
    ov = smoke_overrides(arch, **extra)
    res = dryrun.run_cell(arch, shape, overrides=ov, verbose=False)
    assert set(res) == RESULT_KEYS and res["ok"] and res["chips"] == 256
    assert set(res["memory"]) == MEMORY_KEYS
    assert res["memory"]["temp_size_in_bytes"] is None
    assert res["memory"]["argument_size_in_bytes"] > 0
    assert set(res["collectives"]) == {"bytes_by_kind", "counts",
                                       "total_bytes"}
    assert sum(res["collectives"]["counts"].values()) > 0
    assert list(res["roofline"]) == list(jha.Roofline(0, 0, 0, 1).to_dict())
    assert res["compile_s"] == 0.0 and res["flops"] > 0
    json.dumps(res)
    # one device: the same cell without a mesh, on meta
    cfg = dataclasses.replace(configs.get_config(arch), **ov)
    built = steps.build_cell(cfg, SHAPES[shape], configs.SINGLE, None)
    one = ha.step_flops(built["fn"], *built["args"])
    ratio = res["chips"] * res["flops"] / one
    print(f"{arch} {shape}: chips x per-device / one device = {ratio:.3f}")
    assert ratio >= 1.0
    assert torch.distributed.is_initialized() is False


def test_dryrun_cli_writes_the_cell(tmp_path, small_cells):
    out = tmp_path / "cell.json"
    ov = smoke_overrides("smollm-360m")
    sets = ",".join(f"{k}={int(v)}" for k, v in ov.items()
                    if k in ("n_layers", "d_model", "d_ff", "vocab",
                             "head_dim", "n_heads", "n_kv_heads"))
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                        "--set", sets, "--out", str(out)]) == 0
    (res,) = json.loads(out.read_text())
    assert res["ok"] and res["mesh"] == "16x16" and set(res) == RESULT_KEYS


def test_sweep_skips_cells_already_ok(tmp_path, monkeypatch, capsys):
    out = tmp_path / "smollm-360m__decode_32k__16x16.json"
    out.write_text(json.dumps([{"ok": True}]))
    monkeypatch.setattr(sweep.subprocess, "run", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("a done cell was rerun")))
    sweep.main(["--only", "smollm-360m:decode_32k", "--out", str(tmp_path)])
    assert "complete: 1/1 OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the toggles
# ---------------------------------------------------------------------------

def test_scan_layers_and_remat_prevent_cse_change_nothing():
    cfg = configs.get_config("recurrentgemma-9b").smoke()
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, configs.SINGLE,
                       device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    batch = dict(tokens=toks, labels=toks)
    outs = []
    for over in ({}, {"scan_layers": False}, {"remat_prevent_cse": True},
                 {"remat": True, "remat_prevent_cse": True}):
        c = dataclasses.replace(cfg, **over)
        logits, _ = T.prefill(params, c, configs.SINGLE, tokens=toks)
        p = {k: v for k, v in params.items()}
        p = jax.tree_util.tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = T.lm_loss(p, batch, c, configs.SINGLE)
        outs.append((logits, loss))
    for logits, loss in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        assert torch.equal(loss, outs[0][1])


def test_full_attn_analysis_pins_full_in_dispatch_and_plan():
    cfg = configs.get_config("smollm-360m").smoke()
    geo = dict(seq_q=8192, seq_kv=8192, heads=4, causal=True, window=None,
               qmode="serve")
    assert L.resolve_attn_engine(cfg, **geo) in ("chunked", "flash")
    pinned = dataclasses.replace(cfg, full_attn_analysis=True)
    assert L.resolve_attn_engine(pinned, **geo) == "full"
    rg = dataclasses.replace(configs.get_config("recurrentgemma-9b").smoke(),
                             full_attn_analysis=True, banded_attn=True)
    banded = dict(geo, window=64)
    assert L.resolve_attn_engine(
        dataclasses.replace(rg, full_attn_analysis=False), **banded) \
        == L.resolve_attn_engine(rg, **banded)
    assert L.analysis_attn_engine(pinned, "banded") == "banded"
    params = T.init_lm(torch.Generator().manual_seed(0), pinned,
                       configs.SINGLE, device="cpu")
    plan = tplan.compile_lm(params, dataclasses.replace(
        pinned, quant=quant.W1A8), prompt_len=8192, batch_hints=(1,))
    assert set(plan.attn_table.values()) == {"full"}


def test_static_act_scale_qdense_equals_reference():
    """The prequantized serve ``qdense`` with a static activation scale,
    against the reference's ``set_static_act_scale`` path on the
    reference's prequantized levels, bit for bit; unset, dynamic absmax
    again."""
    rs = np.random.RandomState(0)
    x = rs.randn(6, 64).astype(np.float32)
    w = (rs.randn(64, 32) / 8.0).astype(np.float32)
    jq = jquant.W1A8
    lv, s, z = jquant.weight_levels(jnp.asarray(w), jq.w_bits)
    jw = {"q": lv.astype(jnp.int8), "s": s, "z": z}
    tw = convert.lm_params_from_numpy({"w": jax.tree.map(np.asarray, jw)},
                                      quant.W1A8, device="cpu")["w"]
    dyn = L.qdense(torch.from_numpy(x), tw, quant.W1A8).numpy()
    try:
        JL.set_static_act_scale(0.05)
        L.set_static_act_scale(0.05)
        ref = np.asarray(jax.jit(lambda a: JL.qdense(a, jw, jq))(x))
        got = L.qdense(torch.from_numpy(x), tw, quant.W1A8).numpy()
    finally:
        JL.set_static_act_scale(0.0)
        L.set_static_act_scale(0.0)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, dyn)
    np.testing.assert_array_equal(
        L.qdense(torch.from_numpy(x), tw, quant.W1A8).numpy(), dyn)


def test_constrain_acts_pins_the_residual_stream_batch_split():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with dryrun.fake_world(256):
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(device_type="cpu")
        plan = configs.make_plan({"data": 16, "model": 16})
        h = distribute_tensor(torch.empty(32, 8, 64, device="meta"), mesh,
                              [Replicate(), Shard(1)])
        cfg = configs.get_config("smollm-360m")
        assert T._constrain_batch(h, cfg, plan) is h
        on = dataclasses.replace(cfg, constrain_acts=True)
        assert tuple(T._constrain_batch(h, on, plan).placements) == (
            Shard(0), Replicate())
        odd = distribute_tensor(torch.empty(8, 8, 64, device="meta"), mesh,
                                [Replicate(), Shard(1)])
        assert T._constrain_batch(odd, on, plan) is odd
        plain = torch.zeros(32, 8, 64)
        assert T._constrain_batch(plain, on, plan) is plain

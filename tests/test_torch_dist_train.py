"""The LM trainer over a device mesh, on the CPU: 4 ``gloo`` ranks, the
params, optimizer state and batch as DTensors placed by
``distributed.sharding``, held against the reference's one-device step
and the port's one-process ``Trainer``; checkpoints of DTensors and
elastic remesh.

* Meshes ``("data", "model")`` = (2, 2) and (4, 1) for smollm-360m, and
  (2, 2) for granite-moe-3b-a800m (its experts split over ``model``),
  ``.smoke()`` at W1A8, params drawn with numpy in the reference's layout,
  ``lm_batch`` batches of 4 x 16.  Step 1's loss within ``LOSS_TOL``
  (relative), its metrics and every gathered gradient leaf within
  ``GRAD_TOL`` x the leaf's max|g| of ``jax.value_and_grad(lm_loss)``
  (the tolerances of ``test_torch_train_lm_grads.py``).  The params
  after each of two AdamW steps within ``STEP_TOL`` of the reference
  optimizer (``apply_updates``, one device) fed the trainer's own gathered
  gradients from the same params: AdamW normalizes each element's update,
  so an ulp in a near-zero gradient element, or one flipped activation
  level, moves a param by up to the step's lr, and the gradients are
  held on their own above.  Step 2's loss (at the params after step 1)
  within ``LOSS_TOL``, except where an ulp flips one per-tensor
  activation level there: those pairs are pinned in ``FLIPS`` (the
  divergence exists and stays under ``LOSS_FLIP_BOUND``; ROADMAP Queue
  C).  The reference runs at its single-device plan: the smoke configs'
  4 query heads need no padding at ``tp = 2`` (``padded_heads(4) == 4``),
  so its ``tp = 2`` plan computes the same function and differs only in
  sharding hints that need a mesh.  The same checks hold the port's
  one-process ``Trainer`` on the same params and batches.
* Checkpoint and elastic: the (2, 2) smollm trainer saves after two steps
  (rank 0 writes full arrays); its params re-placed at (4, 1) through
  ``elastic.remesh`` and through a (4, 1) trainer's ``restore`` are
  bit-identical full arrays; one more step of the restored trainer equals
  the uninterrupted (2, 2) run's within the tolerances above.
* ``sharding.per_head`` at (2, 2): the attention core sees each rank's
  own batch rows and heads, and its gathered output and gradients equal
  the core on whole tensors bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.data.synthetic import lm_batch as jlm_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import elastic  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

from test_torch_dist import init_rank, join_ranks, spawn_ranks  # noqa: E402
from test_torch_families import numpy_params  # noqa: E402
from test_torch_train_cnn import one_torch_thread  # noqa: E402,F401

LOSS_TOL = 1e-6      # relative
GRAD_TOL = 1e-4      # x max|g| of each leaf
STEP_TOL = 1e-5      # absolute, the optimizer on the same gradients
LOSS_FLIP_BOUND = 1e-4   # relative (measured 1.0e-5)
# (run, against) pairs whose step-2 forward flips one activation level:
# the (4, 1) mesh sums as the one-process trainer does, the (2, 2) mesh
# as the reference does, and the two orders part at one ulp there
FLIPS = {(("smollm-360m", (4, 1)), "reference"),
         (("smollm-360m", (2, 2)), "single"),
         ("smollm-360m", "reference")}
CASES = (("smollm-360m", (2, 2)), ("smollm-360m", (4, 1)),
         ("granite-moe-3b-a800m", (2, 2)))
ARCHS = sorted({a for a, _ in CASES})
OPT = dict(lr=3e-3, warmup_steps=5)


def _cfgs(arch):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(),
                               quant=jquant.W1A8)
    cfg = dataclasses.replace(configs.get_config(arch).smoke(),
                              quant=quant.W1A8)
    return jcfg, cfg


def _raw(arch):
    return numpy_params(_cfgs(arch)[0], seed=1)


def _batch(step):
    return jlm_batch(step, 0, batch=4, seq=16, vocab=512, seed=3)


def _trainer(arch, mesh, ckpt_dir=None):
    _, cfg = _cfgs(arch)
    plan = (configs.SINGLE if mesh is None
            else configs.make_plan(shd.mesh_sizes(mesh)))
    return Trainer(cfg, plan, opt.OptConfig(**OPT), TrainConfig(steps=3),
                   ckpt_dir=ckpt_dir, device="cpu", mesh=mesh,
                   params=convert.lm_train_params_from_numpy(_raw(arch),
                                                             "cpu"))


def _numpy(tree):
    return convert.lm_params_to_numpy(shd.full_tree(tree))


def _run(tr) -> dict:
    """Step 1's (loss, metrics, grads), step 1, step 2's (loss, grads) and
    step 2, with the params after each step, all gathered."""
    out = {}
    for s in (0, 1):
        b = tr.place_batch(_batch(s))
        loss, m, g = tr.value_and_grad(b)
        out[s] = dict(loss=float(shd.full_tree(loss)),
                      metrics={k: float(v)
                               for k, v in shd.full_tree(m).items()},
                      grads=_numpy(g))
        out[s]["step"] = {k: float(v) for k, v in tr.train_step(b).items()}
        out[s]["params"] = _numpy(tr.params)
    return out


def _rank_main(rank: int, world: int, d: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    init_rank(rank, world, d)
    mesh = {s: init_device_mesh("cpu", s, mesh_dim_names=("data", "model"))
            for s in ((2, 2), (4, 1))}
    out, keep = {}, None
    for arch, shape in CASES:
        ck = os.path.join(d, "ckpt") if (arch, shape) == CASES[0] else None
        tr = _trainer(arch, mesh[shape], ckpt_dir=ck)
        out[(arch, shape)] = _run(tr)
        if ck:
            keep = tr
    # checkpoint at (2, 2), remesh to (4, 1) two ways, one more step
    tr = keep
    tr.ckpt.save(2, dict(params=tr.params, opt=tr.opt_state))
    tr.ckpt.wait()
    _, cfg = _cfgs(CASES[0][0])
    axes = T.lm_param_axes(cfg, tr.plan)
    moved, st = elastic.remesh(tr.params, axes, cfg,
                               elastic.build(mesh[(2, 2)]), mesh[(4, 1)])
    back = _trainer(CASES[0][0], mesh[(4, 1)], ckpt_dir=tr.ckpt.dir)
    restored = back.restore()
    el = dict(before=_numpy(tr.params), remeshed=_numpy(moved),
              restored=_numpy(back.params), restored_ok=restored,
              step=back.step, plan=dataclasses.astuple(st.plan))
    back.train_step(back.place_batch(_batch(2)))
    tr.train_step(tr.place_batch(_batch(2)))
    el.update(after_restore=_numpy(back.params), uninterrupted=_numpy(
        tr.params))
    out["elastic"] = el
    out["per_head"] = _per_head_case(mesh[(2, 2)])
    if rank == 0:
        torch.save(out, os.path.join(d, "out.pt"))
    dist.destroy_process_group()


def _per_head_inputs():
    """q (4 heads), k and v (2 KV heads) of 4 x 8 tokens x 16, and the
    causal ``attn_full`` core over positions 0..7."""
    from repro_torch.models.layers import attn_full

    g = torch.Generator().manual_seed(0)
    qkv = [torch.randn(4, 8, h, 16, generator=g) for h in (4, 2, 2)]
    pos = torch.arange(8)
    return qkv, lambda q, k, v: attn_full(q, k, v, causal=True, window=None,
                                          q_pos=pos, kv_pos=pos)


def _per_head_case(mesh) -> dict:
    """``sharding.per_head`` at (2, 2): q split over the batch (``data``)
    and the heads (``model``), k and v over the batch only; the shapes the
    core saw, and the gathered output and gradients of sum(y^2)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import expand_kv

    (q, k, v), attn = _per_head_inputs()
    seen = []

    def core(q, k, v):
        seen.append(tuple(q.shape))
        return attn(q, k, v)

    qd = distribute_tensor(q, mesh, [Shard(0), Shard(2)]).requires_grad_()
    kd, vd = (distribute_tensor(t, mesh, [Shard(0), Replicate()])
              .requires_grad_() for t in (k, v))
    with shd.on_mesh():
        y = shd.per_head(core, qd, kd, vd,
                         lambda a, b: expand_kv(a, b, 4, 4)).full_tensor()
        grads = torch.autograd.grad(y.pow(2).sum(), [qd, kd, vd])
    return dict(seen=seen, y=y.detach(),
                grads=[gr.full_tensor() for gr in grads])


def _reference(arch) -> dict:
    """The reference's one-device step-1 loss, metrics and gradients and
    its step-2 loss on the same params and batches."""
    jcfg, _ = _cfgs(arch)
    raw = _raw(arch)
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, b, jcfg, jconfigs.SINGLE),
        has_aux=True))(raw, _batch(0))
    jocfg = jopt.OptConfig(**OPT)
    step = jax.jit(jsteps.make_train_step(jcfg, jconfigs.SINGLE, jocfg))
    params, st, steps = raw, jopt.init_opt_state(raw, jocfg), []
    for s in (0, 1):
        params, st, ms = step(params, st, _batch(s))
        steps.append({k: float(v) for k, v in ms.items()})
    return {0: dict(loss=float(loss), grads=jax.tree.map(np.asarray, g),
                    metrics={k: float(v) for k, v in m.items()},
                    step=steps[0]),
            1: dict(metrics=dict(loss=steps[1]["loss"]))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank run (spawned first), the reference's and the port's
    one-process runs computed while it goes."""
    d = str(tmp_path_factory.mktemp("dist_train"))
    ctx = spawn_ranks(_rank_main, (d,))
    torch.set_num_threads(1)
    ref = {a: _reference(a) for a in ARCHS}
    single = {a: _run(_trainer(a, None)) for a in ARCHS}
    join_ranks(ctx)
    return torch.load(os.path.join(d, "out.pt"), weights_only=False), ref, \
        single


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _hold(got: dict, want: dict, flips: bool) -> None:
    a, b = got[0], want[0]
    assert abs(a["loss"] - b["loss"]) <= LOSS_TOL * abs(b["loss"])
    for k in ("aux", "acc"):
        np.testing.assert_allclose(a["metrics"][k], b["metrics"][k],
                                   rtol=LOSS_TOL, atol=1e-12, err_msg=k)
    g, w = dict(_leaves(a["grads"])), dict(_leaves(b["grads"]))
    assert g.keys() == w.keys()
    for k in w:
        assert np.abs(g[k] - w[k]).max() <= GRAD_TOL * max(
            np.abs(w[k]).max(), 1e-30), k
    for k in ("loss", "acc", "lr"):
        np.testing.assert_allclose(a["step"][k], b["step"][k],
                                   rtol=LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(a["step"]["grad_norm"],
                               b["step"]["grad_norm"], rtol=GRAD_TOL)
    a, b = got[1]["metrics"]["loss"], want[1]["metrics"]["loss"]
    rel = abs(a - b) / abs(b)
    if flips:
        assert LOSS_TOL < rel <= LOSS_FLIP_BOUND, rel
    else:
        assert rel <= LOSS_TOL, rel


def _hold_optimizer(arch, run: dict) -> None:
    """Each step's params against the reference optimizer applied to the
    run's own gradients, from the same params."""
    jocfg = jopt.OptConfig(**OPT)
    upd = jax.jit(lambda p, g, st: jopt.apply_updates(p, g, st, jocfg))
    params, st = _raw(arch), jopt.init_opt_state(_raw(arch), jocfg)
    for s in (0, 1):
        params, st, _ = upd(params, run[s]["grads"], st)
        want = dict(_leaves(jax.tree.map(np.asarray, params)))
        got = dict(_leaves(run[s]["params"]))
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= STEP_TOL, (s, k)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_mesh_trainer_equals_reference_one_device_step(runs, case):
    out, ref, _ = runs
    _hold(out[case], ref[case[0]], (case, "reference") in FLIPS)
    _hold_optimizer(case[0], out[case])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_mesh_trainer_equals_one_process_trainer(runs, case):
    out, _, single = runs
    _hold(out[case], single[case[0]], (case, "single") in FLIPS)


def test_one_process_trainer_equals_reference(runs):
    _, ref, single = runs
    for a in ARCHS:
        _hold(single[a], ref[a], (a, "reference") in FLIPS)
        _hold_optimizer(a, single[a])


def test_checkpoint_remesh_bit_identical_and_resumes(runs):
    el = runs[0]["elastic"]
    assert el["restored_ok"] and el["step"] == 2
    assert el["plan"] == dataclasses.astuple(
        configs.make_plan({"data": 4, "model": 1}))
    before = dict(_leaves(el["before"]))
    for key in ("remeshed", "restored"):
        got = dict(_leaves(el[key]))
        assert got.keys() == before.keys()
        for k in before:
            np.testing.assert_array_equal(got[k], before[k], err_msg=key + k)
    a, b = dict(_leaves(el["after_restore"])), dict(_leaves(
        el["uninterrupted"]))
    for k in b:
        assert np.abs(a[k] - b[k]).max() <= STEP_TOL, k


def test_per_head_runs_the_core_on_each_ranks_heads(runs):
    """At (2, 2) the attention core sees each rank's 2 of 4 batch rows and
    2 of 4 heads (tensor parallelism keeps attention split), and the
    gathered output and gradients equal the core on whole tensors bit for
    bit (attention is independent per row and per head)."""
    from repro_torch.models.layers import expand_kv

    ph = runs[0]["per_head"]
    assert ph["seen"] == [(2, 8, 2, 16)]
    (q, k, v), attn = _per_head_inputs()
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    y = attn(q, *expand_kv(k, v, 4, 4))
    want = torch.autograd.grad(y.pow(2).sum(), [q, k, v])
    torch.testing.assert_close(ph["y"], y.detach(), rtol=0, atol=0)
    for got, w in zip(ph["grads"], want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)

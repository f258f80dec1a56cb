"""Port parity for the distributed layer, on the CPU: sharding rules,
meshes, the data-parallel serving engine, the compressed all-reduce over
a process group and the GPipe pipeline (the trainer over a mesh,
checkpoints and elastic remesh: ``test_torch_dist_train.py``).

* ``make_plan``, the params' logical axes (all ten archs at ``.smoke()``)
  and every leaf's ``pspec_for`` / ``batch_shardings`` spec at five mesh
  shapes equal the reference's exactly; so do ``shard_assignment``,
  ``straggler_backup`` and ``bubble_fraction`` over a grid.
* Multi-rank checks run 4 ``gloo`` ranks under ``torch.multiprocessing``
  (one spawn a module, each rank on one torch thread, joined within
  ``JOIN_S``): ``compressed_allreduce(group=)`` against the reference's
  ``compressed_allreduce(axis_name="r")`` under ``jax.vmap`` over the 4
  ranks' gradients (levels, scales and residuals bit for bit, the mean
  within ``MEAN_ULPS`` ulps: the reference sums in XLA's order, the port
  in rank order); ``pipeline_apply`` at ``("pipe", "data")`` = (4, 1) and
  (2, 2), its output and ``d sum(y) / dWs`` against the reference's
  sequential oracle and its ``jax.grad`` at the reference test's
  ``rtol = atol = 2e-5``.
* The data-parallel CNN engine over four CPU replicas is bit-identical to
  one device (the contract of the reference's ``tests/test_engine.py``)
  and within the reference drift of ``test_torch_forward.py`` of the
  reference's own engine; the LM bucket engine over two replicas serves
  each shard's tokens as that shard served alone.
* ``launch.train --devices 2 --device cpu`` logs the losses of
  ``--devices 1`` within ``LOSS_TOL``.
"""
import dataclasses
import os
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import engine as jengine  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro.distributed import pipeline as jpipe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.distributed import pipeline as pipe  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.engine import (CNNRunner, LMRunner,  # noqa: E402
                                       ServeEngine)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import elastic  # noqa: E402

from test_torch_cnn import _both_plans  # noqa: E402
from test_torch_forward import _self_calibrated_tol  # noqa: E402
from test_torch_train_cnn import one_torch_thread  # noqa: E402,F401

WORLD = 4
JOIN_S = 120           # a hung rank fails the test instead of the run
MEAN_ULPS = 2
PIPE_TOL = 2e-5        # the reference test's rtol = atol
LOSS_TOL = 1e-6        # relative, as test_torch_train_lm_grads.py
PIPE = dict(M=8, mb=2, d=16)
PIPE_MESHES = ((4, 1), (2, 2))
MESH_SHAPES = ({"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16},
               {"data": 4, "model": 1}, {"data": 2, "model": 2},
               {"data": 1, "model": 4})


def spawn_ranks(fn, args, world: int = WORLD):
    """Start ``fn(rank, world, *args)`` in ``world`` spawned processes
    (``join_ranks`` waits for them)."""
    return mp.spawn(fn, args=(world,) + tuple(args), nprocs=world,
                    join=False)


def join_ranks(ctx) -> None:
    """Wait for the ranks; raises if one failed or they have not all
    ended within ``JOIN_S`` (then they are killed)."""
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"ranks still running after {JOIN_S} s")


def init_rank(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world)


# ---------------------------------------------------------------------------
# pure logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inference", [False, True])
def test_make_plan_equals_reference(inference):
    for shape in MESH_SHAPES + ({"data": 8}, {}):
        assert dataclasses.astuple(configs.make_plan(
            shape, inference=inference)) == dataclasses.astuple(
            jconfigs.make_plan(shape, inference=inference))
    assert dataclasses.astuple(configs.SINGLE) == dataclasses.astuple(
        jconfigs.SINGLE)
    for tp in (1, 2, 3, 16):
        p = configs.make_plan({"data": 2, "model": tp})
        jp = jconfigs.make_plan({"data": 2, "model": tp})
        for n in (0, 1, 2, 4, 15, 16, 64):
            assert (p.padded_heads(max(n, 1)), p.shard_kv(n),
                    p.shard_experts(n)) == (jp.padded_heads(max(n, 1)),
                                            jp.shard_kv(n),
                                            jp.shard_experts(n))


def _reference_axes_and_shapes(arch, jplan):
    """The reference's ``init_lm`` (params shapes, axes), traced without
    drawing a number."""
    jcfg = jconfigs.get_config(arch).smoke()
    box = {}

    def f(k):
        p, a = JT.init_lm(k, jcfg, jplan)
        box["axes"] = a
        return p

    shapes = jax.eval_shape(f, jax.random.PRNGKey(0))
    return jcfg, shapes, box["axes"]


def _pairs(tree, axes, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], axes[k], f"{path}/{k}")
    else:
        yield path, tree, axes


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_axes_and_specs_equal_reference(arch):
    """``lm_param_axes`` is the reference's ``init_lm`` axes tree leaf for
    leaf, at the single-device plan and a (2, 2) one; and at every mesh
    shape, each leaf's ``pspec_for`` and ``tree_specs`` equal the
    reference's ``pspec_for`` under that mesh's ``make_plan``."""
    cfg = configs.get_config(arch).smoke()
    for jplan, plan in ((jconfigs.SINGLE, configs.SINGLE),
                        (jconfigs.make_plan({"data": 2, "model": 2}),
                         configs.make_plan({"data": 2, "model": 2}))):
        jcfg, shapes, jaxes = _reference_axes_and_shapes(arch, jplan)
        axes = T.lm_param_axes(cfg, plan)
        got = {p: a for p, _, a in _pairs(shapes, axes)}
        want = {p: a for p, _, a in _pairs(shapes, jaxes)}
        assert got == want
    for shape in MESH_SHAPES:
        mesh = _FakeMesh(shape)
        jplan, plan = jconfigs.make_plan(shape), configs.make_plan(shape)
        jcfg, shapes, jaxes = _reference_axes_and_shapes(arch, jplan)
        specs = shd.tree_specs(shapes, T.lm_param_axes(cfg, plan), plan,
                               mesh, cfg)
        for path, sd, ax in _pairs(shapes, jaxes):
            want = tuple(jshd.pspec_for(sd.shape, ax, jplan, mesh, jcfg))
            assert shd.pspec_for(sd.shape, ax, plan, mesh, cfg) == want, path
            node = specs
            for k in path.strip("/").split("/"):
                node = node[k]
            assert node == want, path


def test_head_padded_params_keep_the_reference_layout_at_tp2():
    """At ``tp = 2`` a 3-head config pads its query heads to 4
    (zero-masked): the port's ``init_lm`` shapes, its axes and each
    leaf's spec on a (1, 2) mesh equal the reference's at the same plan,
    so params carried across at that plan keep their layout."""
    plan = configs.make_plan({"data": 1, "model": 2})
    jplan = jconfigs.make_plan({"data": 1, "model": 2})
    over = dict(n_heads=3, n_kv_heads=1)
    cfg = configs.get_config("smollm-360m").smoke(**over)
    jcfg = jconfigs.get_config("smollm-360m").smoke(**over)
    box = {}

    def f(k):
        p, box["axes"] = JT.init_lm(k, jcfg, jplan)
        return p

    shapes = jax.eval_shape(f, jax.random.PRNGKey(0))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, plan)
    assert plan.padded_heads(3) == 4
    assert params["blocks"]["attn"]["attn"]["wq"].shape[-1] == 4 * cfg.hd
    mesh = _FakeMesh({"data": 1, "model": 2})
    for (path, sd, ax), (_, p, tax) in zip(
            _pairs(shapes, box["axes"]),
            _pairs(params, T.lm_param_axes(cfg, plan))):
        assert tuple(p.shape) == tuple(sd.shape) and tax == ax, path
        assert shd.pspec_for(p.shape, tax, plan, mesh, cfg) == tuple(
            jshd.pspec_for(sd.shape, ax, jplan, mesh, jcfg)), path


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_batch_specs_and_placements_equal_reference(shape):
    """``batch_spec`` / ``batch_shardings`` / ``batch_pspec`` against the
    reference's on an abstract mesh of the same shape (divisible and
    indivisible batches, a 0-d leaf); the placements put ``Shard(0)`` on
    exactly the spec's mesh axes of more than one rank."""
    from jax.sharding import AbstractMesh
    from torch.distributed.tensor import Replicate, Shard

    jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    mesh = _FakeMesh(shape)
    plan, jplan = configs.make_plan(shape), jconfigs.make_plan(shape)
    tree = {f"b{b}": types.SimpleNamespace(shape=(b, 7), ndim=2)
            for b in (1, 3, 4, 8, 32, 256, 512)}
    tree["scalar"] = types.SimpleNamespace(shape=(), ndim=0)
    want = jshd.batch_shardings(tree, jplan, jmesh)
    got = shd.batch_shardings(tree, plan, mesh)
    for k, leaf in tree.items():
        spec = tuple(want[k].spec)
        spec = spec + (None,) * (len(leaf.shape) - len(spec)) if spec else ()
        assert shd.batch_spec(leaf.shape, plan, mesh) == spec, k
        split = set(spec[0] if spec and isinstance(spec[0], tuple)
                    else spec[:1] if spec and spec[0] else ())
        assert got[k] == tuple(Shard(0) if a in split and n > 1
                               else Replicate()
                               for a, n in shape.items()), k
    for ndim, bd in ((1, 0), (3, 0), (3, 1)):
        assert shd.batch_pspec(plan, ndim, bd) == tuple(
            jshd.batch_pspec(jplan, ndim, bd))


def test_elastic_and_pipeline_arithmetic_equal_reference():
    for n in (1, 2, 3, 4, 8, 16):
        for step in range(5):
            for micro in range(3):
                assert elastic.shard_assignment(n, step, micro, 64) == \
                    jelastic.shard_assignment(n, step, micro, 64)
                for h in range(n):
                    assert elastic.straggler_backup(h, n, step, micro) == \
                        jelastic.straggler_backup(h, n, step, micro)
    for m in (1, 2, 8, 32):
        for s in (1, 2, 4, 16):
            assert pipe.bubble_fraction(m, s) == jpipe.bubble_fraction(m, s)


def test_host_meshes_refuse_a_world_they_cannot_fill():
    """One process and no group: the world is 1, so the production meshes
    raise naming the ranks they need; the CPU serving mesh is ``None`` on
    one device and ``n`` CPU devices otherwise."""
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="model=2"):
        tmesh.make_host_mesh(model=2, device_type="cpu")
    assert tmesh.make_serve_mesh(device_type="cpu") is None
    assert tmesh.make_serve_mesh(3, device_type="cpu") == \
        (torch.device("cpu"),) * 3
    assert tmesh.mesh_shape_dict(_FakeMesh({"data": 2})) == {"data": 2}


# ---------------------------------------------------------------------------
# data-parallel serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_pad_to_equals_reference_rule(n):
    """Bucket padding with ``n`` devices: the next power of two capped at
    ``max_batch``, rounded up to a multiple of ``n`` (the reference's
    ``_pad_to``, whose device count comes from its mesh)."""
    compiled = _svhn_compiled()
    mesh = None if n == 1 else (torch.device("cpu"),) * n
    eng = ServeEngine(CNNRunner(compiled.plan), max_batch=8, mesh=mesh)
    ref = jengine.ServeEngine.__new__(jengine.ServeEngine)
    ref.batcher = jengine.BucketBatcher(8, 0.005)
    ref._n_data = n
    for k in range(1, 13):
        assert eng._pad_to(k) == ref._pad_to(k), (n, k)


def _svhn_compiled():
    from repro_torch import api

    params = cnn.init_cnn(torch.Generator().manual_seed(0),
                          cnn.svhn_cnn_spec(8))
    return api.build(cnn.svhn_cnn_spec(8), quant.W1A4, params=params,
                     img_hw=40).compile(batch_hints=(1, 8))


def test_cnn_engine_over_four_replicas_bit_identical():
    """svhn(8) W1A4, 12 requests at ``max_batch=8`` (a full bucket and a
    ragged one, padded to 4 and split 1 a replica): the four-replica
    engine's logits equal the single-device engine's and each request's
    alone bit for bit; the reference's single-device engine on the same
    levels agrees in argmax and within its own jit-vs-eager drift (the
    port's CNN is held to the reference at that tolerance,
    ``test_torch_forward.py``)."""
    jp, tp = _both_plans(jcnn.svhn_cnn_spec(8), cnn.svhn_cnn_spec(8),
                         "w1a4", 40, 8, seed=1)
    rs = np.random.RandomState(6)
    images = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
              for _ in range(12)]
    one = ServeEngine(CNNRunner(tp), max_batch=8)
    four = ServeEngine(CNNRunner(tp), max_batch=8,
                       mesh=("cpu", "cpu", "cpu", "cpu"))
    a = np.stack([r.value for r in one.serve(images)])
    got = four.serve(images)
    assert [r.padded for r in got] == [8] * 8 + [4] * 4
    assert four.stats == dict(dispatches=2, requests=12, padded_rows=0)
    b = np.stack([r.value for r in got])
    np.testing.assert_array_equal(a, b)
    for img, row in zip(images[8:], b[8:]):
        np.testing.assert_array_equal(row, one.serve([img])[0].value)
    jeng = jengine.ServeEngine(jengine.CNNRunner(None, None, None, plan=jp),
                               max_batch=8)
    ref = np.stack([np.asarray(r.value) for r in jeng.serve(images)])
    _, tol = _self_calibrated_tol(jp, np.stack(images[:8]))
    np.testing.assert_array_equal(b.argmax(-1), ref.argmax(-1))
    assert np.abs(b - ref).max() <= tol


def test_lm_engine_over_two_replicas_serves_each_shard_alone():
    """Two prompts over two CPU replicas of a smoke SmolLM W1A8: each
    replica's forward runs on its own shard, so each prompt's tokens are
    those it gets served alone (per-tensor activation scales see one
    shard, as under the reference's ``shard_map``)."""
    from test_torch_families import numpy_params
    from repro_torch import convert
    from repro_torch.models.layers import prequantize_params

    jcfg = dataclasses.replace(jconfigs.get_config("smollm-360m").smoke(),
                               quant=jquant.W1A8)
    cfg = dataclasses.replace(configs.get_config("smollm-360m").smoke(),
                              quant=quant.W1A8)
    params = prequantize_params(convert.lm_train_params_from_numpy(
        numpy_params(jcfg, seed=4), "cpu"), cfg)
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, cfg.vocab, (12,)).astype(np.int32)
               for _ in range(2)]
    runner = LMRunner(params, cfg, new_tokens=4)
    with torch.no_grad():
        two = ServeEngine(runner, max_batch=2, mesh=("cpu", "cpu"))
        got = [r.value for r in two.serve(prompts)]
        alone = [ServeEngine(runner, max_batch=1).serve([p])[0].value
                 for p in prompts]
        both = [r.value for r in ServeEngine(runner, max_batch=2)
                .serve(prompts)]
    for g, a in zip(got, alone):
        np.testing.assert_array_equal(g, a)
    assert two.stats["dispatches"] == 1
    assert all(len(t) == 4 for t in both)


# ---------------------------------------------------------------------------
# compressed all-reduce and the pipeline over 4 gloo ranks
# ---------------------------------------------------------------------------

def _grads(rank: int) -> dict:
    rs = np.random.RandomState(100 + rank)
    return {"a": (rs.randn(33) * 10 ** rs.uniform(-3, 1)).astype(np.float32),
            "b": {"w": (rs.randn(5, 7) * 0.01).astype(np.float32)}}


def _residuals(rank: int) -> dict:
    rs = np.random.RandomState(200 + rank)
    return {"a": (rs.randn(33) * 1e-3).astype(np.float32),
            "b": {"w": (rs.randn(5, 7) * 1e-5).astype(np.float32)}}


def _pipe_inputs(stages: int):
    rs = np.random.RandomState(stages)
    ws = (rs.randn(stages, PIPE["d"], PIPE["d"]) * 0.2).astype(np.float32)
    x = rs.randn(PIPE["M"], PIPE["mb"], PIPE["d"]).astype(np.float32)
    return ws, x


def _stage_fn(w, x):
    return torch.tanh(x @ w)


def _rank_main(rank: int, world: int, d: str) -> None:
    """Compression over the world group, then the pipeline at each mesh of
    ``PIPE_MESHES``; rank 0 saves what it got."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    init_rank(rank, world, d)
    tt = lambda t: {k: (tt(v) if isinstance(v, dict)  # noqa: E731
                        else torch.from_numpy(v)) for k, v in t.items()}
    g, e = tt(_grads(rank)), tt(_residuals(rank))
    mean, ef = comp.compressed_allreduce(g, e, group=dist.group.WORLD)
    levels = comp.compress(g["a"] + e["a"])
    out = {"comp": dict(mean=mean, ef=ef, levels=levels)}
    gathered = [None] * world
    dist.all_gather_object(gathered, out["comp"])
    out["comp"] = gathered
    for shape in PIPE_MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("pipe", "data"))
        ws, x = _pipe_inputs(shape[0])
        wd = distribute_tensor(torch.from_numpy(ws), mesh,
                               [Shard(0), Replicate()]).requires_grad_()
        xd = distribute_tensor(torch.from_numpy(x), mesh,
                               [Replicate(), Shard(1)])
        y = pipe.pipeline_apply(_stage_fn, wd, xd, mesh=mesh,
                                n_microbatches=PIPE["M"])
        yf = y.full_tensor()
        gw, = torch.autograd.grad(yf.sum(), [wd])
        out[shape] = dict(y=yf.detach(), dw=gw.full_tensor())
    if rank == 0:
        torch.save(out, os.path.join(d, "out.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    join_ranks(spawn_ranks(_rank_main, (d,)))
    return torch.load(os.path.join(d, "out.pt"), weights_only=False)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def test_compressed_allreduce_over_a_group_equals_reference(ranks_out):
    """4 ranks: every rank's mean gradient against the reference's
    ``pmean`` under ``jax.vmap(axis_name="r")`` within ``MEAN_ULPS``, the
    error-feedback residuals and each rank's levels and scale bit for
    bit."""
    G = jax.tree.map(lambda *xs: jnp.stack(xs),
                     *[_grads(r) for r in range(WORLD)])
    E = jax.tree.map(lambda *xs: jnp.stack(xs),
                     *[_residuals(r) for r in range(WORLD)])
    jmean, jef = jax.vmap(lambda g, e: jcomp.compressed_allreduce(
        g, e, axis_name="r"), axis_name="r")(G, E)
    for r, got in enumerate(ranks_out["comp"]):
        for k, sub in (("a", None), ("b", "w")):
            pick = (lambda t: t[k]) if sub is None else (
                lambda t: t[k][sub])
            assert _ulps(pick(got["mean"]).numpy(),
                         np.asarray(pick(jmean)[r])) <= MEAN_ULPS
            np.testing.assert_array_equal(pick(got["ef"]).numpy(),
                                          np.asarray(pick(jef)[r]))
        lv, sc = jcomp.compress(jnp.asarray(_grads(r)["a"]
                                            + _residuals(r)["a"]))
        np.testing.assert_array_equal(got["levels"][0].numpy(),
                                      np.asarray(lv))
        assert float(got["levels"][1]) == float(sc)


@pytest.mark.parametrize("shape", PIPE_MESHES, ids=["pipe4", "pipe2x2"])
def test_pipeline_equals_sequential_oracle_and_its_grad(ranks_out, shape):
    """GPipe over ``("pipe", "data")``: ``y`` and ``d sum(y) / dWs``
    against the reference's sequential oracle and its ``jax.grad``."""
    ws, x = _pipe_inputs(shape[0])

    def seq(w):
        h = jnp.asarray(x)
        for s in range(shape[0]):
            h = jnp.tanh(h @ w[s])
        return h

    y, vjp = jax.vjp(seq, jnp.asarray(ws))
    dw, = vjp(jnp.ones_like(y))
    got = ranks_out[shape]
    np.testing.assert_allclose(got["y"].numpy(), np.asarray(y),
                               rtol=PIPE_TOL, atol=PIPE_TOL)
    np.testing.assert_allclose(got["dw"].numpy(), np.asarray(dw),
                               rtol=PIPE_TOL, atol=PIPE_TOL)


# ---------------------------------------------------------------------------
# the training CLI over two ranks
# ---------------------------------------------------------------------------

def test_launch_train_devices_2_logs_the_losses_of_one(capsys):
    """``--devices 2 --device cpu`` spawns two ``gloo`` ranks over a
    (2, 1) mesh (the embed rule splits the params' ``embed`` dims, the
    batch splits over ``data``); rank 0 logs, and the logged losses equal
    ``--devices 1``'s within ``LOSS_TOL``.  The two-rank run is a
    subprocess killed after ``JOIN_S``; its history comes back as JSON."""
    import json
    import subprocess
    import sys

    argv = ["--arch", "smollm-360m", "--smoke", "--steps", "3", "--batch",
            "4", "--seq", "16", "--device", "cpu"]
    one = tlaunch.main(argv)
    assert "devices=1" in capsys.readouterr().out
    code = ("import json, sys, torch; torch.set_num_threads(1)\n"
            "from repro_torch.launch import train\n"
            "if __name__ == '__main__':\n"
            "    print('HISTORY', json.dumps(train.main(sys.argv[1:])))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code] + argv
                         + ["--devices", "2"], capture_output=True,
                         text=True, timeout=JOIN_S, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "devices=2" in out.stdout
    two = json.loads(out.stdout.split("HISTORY ", 1)[1])
    assert [h["step"] for h in two] == [h["step"] for h in one] == [1]
    for a, b in zip(one, two):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL * abs(a["loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-5 * a["grad_norm"]


def test_serve_throughput_cli_splits_over_cards_only_when_asked(
        capsys, monkeypatch):
    """``launch.serve --throughput`` serves on one device and prints
    ``devices=1`` unless ``--data-parallel`` asks for the serving mesh
    (here two CPU replicas in place of ``make_serve_mesh()``'s cards)."""
    from repro_torch.launch import serve as tserve

    monkeypatch.setattr(tmesh, "make_serve_mesh", lambda **kw: (
        torch.device("cpu"), torch.device("cpu")))
    argv = ["--device", "cpu", "--quant", "w1a8", "--throughput",
            "--requests", "4", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "2"]
    tserve.main(argv)
    assert "devices=1 " in capsys.readouterr().out
    tserve.main(argv + ["--data-parallel"])
    assert "devices=2 " in capsys.readouterr().out

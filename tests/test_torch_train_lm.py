"""The port's optimizer, gradient compression, LM trainer, step builders
and training CLI held against the jitted reference on the CPU.

* (the loss and gradients against ``jax.value_and_grad``:
  ``test_torch_train_lm_grads.py``)
* ``apply_updates`` for adamw, lion and sgd over 1 and 3 steps within
  1e-6 of the reference's params, state and stats;
* ``compress``: levels exact, scale within 1 ulp; error feedback
  telescopes (the decompressed sum plus the last residual equals the raw
  sum);
* the counterparts of ``test_system.py::test_lm_trainer_end_to_end`` and
  ``::test_compressed_training_reduces_loss``, and
  ``launch.train --device cpu --smoke --steps 3``;
* the full-vocabulary stream (SmolLM's 49152 tokens) at smoke width over
  the card check's 20 steps (W1A8, batch 8, seq 64, lr 3e-3, warmup 5):
  the port's and the reference's training losses stay flat at the
  uniform floor ln 49152 alike (``FULL_VOCAB_FLAT``), from a first step
  that agrees within ``FULL_VOCAB_STEP1`` (relative: the same params and
  batch through a 49152-way float32 log-softmax; later steps part as
  1-bit weights compound the ulps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs import SINGLE  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.data.synthetic import lm_batch, lm_stream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import (TrainConfig, Trainer,  # noqa: E402
                                       trainable)

from test_torch_train_cnn import one_torch_thread  # noqa: E402,F401


STEP_TOL = 1e-6
FULL_VOCAB_FLAT = 0.05     # nats: |loss - ln V| at every step
FULL_VOCAB_STEP1 = 1e-5    # relative, port vs reference, step 1


def _leaves_with_paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {"w": (rs.randn(16, 8) * scale).astype(np.float32),
            "blocks": {"b": (rs.randn(8) * scale).astype(np.float32),
                       "a": (rs.randn(3, 4, 5) * scale).astype(np.float32)}}


@pytest.mark.parametrize("kind", ["adamw", "lion", "sgd"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_apply_updates_equals_reference(kind, n_steps):
    ocfg = opt.OptConfig(kind=kind, lr=1e-2, warmup_steps=2, total_steps=6)
    jocfg = jopt.OptConfig(kind=kind, lr=1e-2, warmup_steps=2, total_steps=6)
    p = _tree(0)
    jp, jst = p, jopt.init_opt_state(p, jocfg)
    tp = convert.lm_train_params_from_numpy(p, "cpu")
    st = opt.init_opt_state(tp, ocfg)
    jupd = jax.jit(lambda a, g, s: jopt.apply_updates(a, g, s, jocfg))
    for i in range(n_steps):
        g = _tree(10 + i, scale=0.5 if i else 3.0)   # step 1 clips
        jp, jst, jstats = jupd(jp, g, jst)
        tg = convert.lm_train_params_from_numpy(g, "cpu")
        tp, st, stats = opt.apply_updates(tp, tg, st, ocfg)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       rtol=STEP_TOL)
    assert int(st["step"]) == int(jst["step"]) == n_steps
    for (path, a), (_, r) in zip(
            _leaves_with_paths(convert.lm_params_to_numpy(tp)),
            _leaves_with_paths(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, r, rtol=0, atol=STEP_TOL, err_msg=path)
    for key in ("m", "v"):
        if key in jst:
            for (path, a), (_, r) in zip(
                    _leaves_with_paths(convert.lm_params_to_numpy(st[key])),
                    _leaves_with_paths(jax.tree.map(np.asarray, jst[key]))):
                np.testing.assert_allclose(a, r, rtol=0, atol=STEP_TOL,
                                           err_msg=f"{key}{path}")


def test_schedule_and_state_axes_follow_reference():
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=20)
    jocfg = jopt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=20)
    js = jax.jit(lambda s: jopt.schedule(jocfg, s))
    for s in range(0, 24):
        got = float(opt.schedule(ocfg, torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, float(js(jnp.int32(s))), rtol=STEP_TOL)
    ax = {"w": ("embed", "mlp")}
    for kind in ("adamw", "lion", "sgd"):
        assert opt.opt_state_axes(ax, opt.OptConfig(kind=kind)) == \
            jopt.opt_state_axes(ax, jopt.OptConfig(kind=kind))
    with pytest.raises(ValueError):
        opt.apply_updates({"w": torch.zeros(2)}, {"w": torch.zeros(2)},
                          {"step": torch.zeros((), dtype=torch.int32)},
                          opt.OptConfig(kind="rmsprop"))


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_compress_levels_exact_scale_within_one_ulp(bits):
    g = np.random.RandomState(bits).randn(64, 33).astype(np.float32) * 0.01
    jl, js = jax.jit(lambda x: jcomp.compress(x, bits))(g)
    lv, sc = comp.compress(torch.from_numpy(g), bits)
    assert lv.dtype == torch.int8
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jl))
    assert abs(float(sc) - float(js)) <= np.spacing(np.float32(js))
    np.testing.assert_array_equal(
        comp.decompress(lv, sc).numpy(),
        np.asarray(jcomp.decompress(jnp.asarray(lv.numpy()),
                                    jnp.float32(float(sc)))))


def test_error_feedback_telescopes_and_matches_reference():
    rs = np.random.RandomState(0)
    grads = [{"a": rs.randn(32, 8).astype(np.float32),
              "b": {"c": rs.randn(5).astype(np.float32)}} for _ in range(5)]
    ef = comp.init_error_feedback(
        convert.lm_train_params_from_numpy(grads[0], "cpu"))
    jef = jcomp.init_error_feedback(grads[0])
    total = sent = None
    for g in grads:
        tg = opt.tree_map(lambda v: v.detach(),
                          convert.lm_train_params_from_numpy(g, "cpu"))
        deq, ef = comp.compressed_allreduce(tg, ef)
        jdeq, jef = jcomp.compressed_allreduce(g, jef)
        for (_, a), (_, r) in zip(
                _leaves_with_paths(convert.lm_params_to_numpy(deq)),
                _leaves_with_paths(jax.tree.map(np.asarray, jdeq))):
            np.testing.assert_allclose(a, r, rtol=0,
                                       atol=1e-6 * np.abs(r).max())
        d = opt.tree_leaves(deq)
        total = ([x.double() for x in opt.tree_leaves(tg)] if total is None
                 else [t + x.double() for t, x in zip(
                     total, opt.tree_leaves(tg))])
        sent = ([x.double() for x in d] if sent is None
                else [s + x.double() for s, x in zip(sent, d)])
    # sum of what was sent + the last residual == sum of the raw gradients
    for t, s, e in zip(total, sent, opt.tree_leaves(ef)):
        np.testing.assert_allclose((s + e.double()).numpy(), t.numpy(),
                                   rtol=0, atol=1e-5)
    p = {"a": torch.zeros(100), "b": torch.zeros(3, 4)}
    assert comp.compression_ratio(p) == pytest.approx(
        jcomp.compression_ratio({"a": np.zeros(100), "b": np.zeros((3, 4))}))


# ---------------------------------------------------------------------------
# trainer, steps, CLI, data
# ---------------------------------------------------------------------------

def _tiny_cfg():
    return configs.get_config("smollm-360m").smoke(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        vocab=64, head_dim=32)


def test_lm_trainer_end_to_end(tmp_path):
    """Loss decreases; checkpoint/restore resumes at step 30 with the
    params bit for bit."""
    cfg = _tiny_cfg()
    tr = Trainer(cfg, SINGLE, opt.OptConfig(lr=3e-3, warmup_steps=5),
                 TrainConfig(steps=30, log_every=10, ckpt_every=10),
                 ckpt_dir=str(tmp_path), device="cpu")
    hist = tr.run(lambda s, m: lm_batch(s, m, batch=4, seq=16, vocab=64,
                                        seed=3), log=lambda *_: None)
    assert [h["step"] for h in hist] == [1, 10, 20, 30]
    assert set(hist[0]) >= {"loss", "acc", "grad_norm", "lr", "step", "sps"}
    assert hist[-1]["loss"] < hist[0]["loss"]
    tr2 = Trainer(cfg, SINGLE, opt.OptConfig(lr=3e-3, warmup_steps=5),
                  TrainConfig(steps=30), ckpt_dir=str(tmp_path), device="cpu")
    assert tr2.restore() and tr2.step == 30
    for a, b in zip(opt.tree_leaves(tr.params), opt.tree_leaves(tr2.params)):
        assert torch.equal(a, b) and b.requires_grad
    assert int(tr2.opt_state["step"]) == 30


def test_compressed_training_reduces_loss():
    cfg = _tiny_cfg()
    tr = Trainer(cfg, SINGLE, opt.OptConfig(lr=3e-3, warmup_steps=5),
                 TrainConfig(steps=25, log_every=24, compress_grads=True),
                 device="cpu")
    hist = tr.run(lambda s, m: lm_batch(s, m, batch=4, seq=16, vocab=64,
                                        seed=4), log=lambda *_: None)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_trainer_on_carried_params_matches_reference_train_step():
    """``Trainer(params=...)`` on the reference's params carried across:
    one ``train_step`` gives the reference ``make_train_step``'s loss,
    accuracy, learning rate and gradient norm, and the step builder the
    same."""
    from repro.launch import steps as jsteps
    from repro.data.synthetic import lm_batch as jlm_batch
    from test_torch_families import numpy_params

    jcfg = jconfigs.get_config("smollm-360m").smoke(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        vocab=64, head_dim=32)
    raw = numpy_params(jcfg, seed=1)
    b = jlm_batch(2, 0, batch=4, seq=16, vocab=64, seed=3)
    jocfg = jopt.OptConfig(lr=3e-3, warmup_steps=5)
    _, _, jm = jax.jit(jsteps.make_train_step(jcfg, jconfigs.SINGLE, jocfg))(
        raw, jopt.init_opt_state(raw, jocfg), b)
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=5)
    tr = Trainer(_tiny_cfg(), SINGLE, ocfg, TrainConfig(steps=1),
                 device="cpu",
                 params=convert.lm_train_params_from_numpy(raw, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    m = tr.train_step(tb)
    params = convert.lm_train_params_from_numpy(raw, "cpu")
    _, _, m2 = tsteps.make_train_step(_tiny_cfg(), SINGLE, ocfg)(
        params, opt.init_opt_state(params, ocfg), tb)
    for got in (m, m2):
        for k in ("loss", "acc", "lr", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), float(jm[k]),
                                       rtol=STEP_TOL, err_msg=k)


def test_trainer_tensor_parallel_plan_needs_a_mesh():
    """A ``tp > 1`` plan splits the model over a ``model`` mesh axis: with
    no mesh the trainer raises, naming ``mesh=``."""
    with pytest.raises(ValueError, match="mesh="):
        Trainer(_tiny_cfg(), configs.make_plan({"data": 1, "model": 2}),
                opt.OptConfig(), TrainConfig(), device="cpu")


def test_launch_train_cli_smoke(capsys):
    hist = tlaunch.main(["--arch", "smollm-360m", "--smoke", "--steps", "3",
                         "--device", "cpu"])
    assert [h["step"] for h in hist] == [1]
    assert np.isfinite(hist[0]["loss"])
    assert "arch=smollm-360m-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-26b"])
def test_launch_batch_fn_modalities(arch):
    cfg = configs.get_config(arch).smoke()
    b = tlaunch.make_batch_fn(cfg, 2, 8, torch.device("cpu"))(3, 0)
    if cfg.frame_input:
        assert set(b) == {"frame_feats", "labels"}
        assert b["frame_feats"].shape == (2, 8, cfg.frame_dim)
    else:
        assert b["patch_embeds"].shape == (2, cfg.n_patches, cfg.vit_dim)
    assert torch.equal(b["labels"], tlaunch.make_batch_fn(
        cfg, 2, 8, torch.device("cpu"))(3, 0)["labels"])


def test_step_builders_and_meta_specs():
    cfg = _tiny_cfg()
    cell = configs.base.ShapeCell("t", "train", 16, 4)
    spec = tsteps.batch_specs(cfg, cell)
    assert {k: tuple(v.shape) for k, v in spec.items()} == {
        "tokens": (4, 16), "labels": (4, 16)}
    assert all(v.device.type == "meta" for v in spec.values())
    jcfg = jconfigs.get_config("smollm-360m").smoke(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128, vocab=64,
        head_dim=32)
    jshapes = jax.eval_shape(lambda k: JT.init_lm(k, jcfg,
                                                  jconfigs.SINGLE)[0],
                             jax.random.PRNGKey(0))
    ap, ap_axes = tsteps.abstract_params(cfg, SINGLE)
    assert {k: tuple(v.shape) for k, v in _leaves_with_paths_meta(ap)} == {
        k: tuple(v.shape) for k, v in _leaves_with_paths_meta(jshapes)}
    ao, ao_axes = tsteps.abstract_opt(ap, opt.OptConfig(), ap_axes)
    assert set(ao) == set(ao_axes) == {"step", "m", "v"}
    ac, ac_axes = tsteps.abstract_cache(cfg, SINGLE, 2, 32)
    assert ac["attn"]["k"].device.type == "meta"
    assert len(ac_axes["attn"]["k"]) == ac["attn"]["k"].ndim
    # the train step runs one update
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, SINGLE,
                       device="cpu")
    params = {k: v for k, v in params.items()}
    params = trainable(params)
    st = opt.init_opt_state(params, opt.OptConfig())
    b = {k: torch.from_numpy(v) for k, v in
         lm_batch(0, 0, batch=2, seq=8, vocab=64).items()}
    step = tsteps.make_train_step(cfg, SINGLE, opt.OptConfig())
    _, st2, m = step(params, st, b)
    assert int(st2["step"]) == 1 and np.isfinite(float(m["loss"]))
    logits, cache = tsteps.make_prefill_step(cfg, SINGLE)(params, b)
    assert logits.shape == (2, cfg.padded_vocab)
    big = T.init_cache(cfg, SINGLE, 2, 12)
    for kind, c in cache.items():
        for k, v in c.items():
            big[kind][k][:, :, :8] = v
    lg, _ = tsteps.make_decode_step(cfg, SINGLE)(
        params, big, b["tokens"][:, :1], 8)
    assert lg.shape == (2, cfg.padded_vocab)


def _leaves_with_paths_meta(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths_meta(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_lm_data_equals_reference():
    from repro.data.synthetic import lm_batch as jlm_batch
    from repro.data.synthetic import lm_stream as jlm_stream

    np.testing.assert_array_equal(lm_stream(500, 97, seed=2),
                                  jlm_stream(500, 97, seed=2))
    for step, micro in [(0, 0), (3, 1), (17, 2)]:
        a = lm_batch(step, micro, batch=3, seq=12, vocab=50, seed=5)
        r = jlm_batch(step, micro, batch=3, seq=12, vocab=50, seed=5)
        assert a.keys() == r.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], r[k])


def test_full_vocab_stream_loss_flat_as_reference():
    """Over SmolLM's whole 49152-token vocabulary, ``lm_batch``'s Markov
    stream gives 20 steps of 512 tokens nothing to learn: the port and the
    reference, from the same params, both train at the uniform floor."""
    from repro.launch import steps as jsteps
    from test_torch_families import numpy_params

    vocab = 49152
    jcfg = dataclasses.replace(
        jconfigs.get_config("smollm-360m").smoke(vocab=vocab),
        quant=jquant.W1A8)
    cfg = dataclasses.replace(
        configs.get_config("smollm-360m").smoke(vocab=vocab),
        quant=quant.W1A8)
    raw = numpy_params(jcfg, seed=0)
    jocfg = jopt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=20)
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=20)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jconfigs.SINGLE, jocfg))
    step = tsteps.make_train_step(cfg, SINGLE, ocfg)
    jp, jst = raw, jopt.init_opt_state(raw, jocfg)
    params = convert.lm_train_params_from_numpy(raw, "cpu")
    st = opt.init_opt_state(params, ocfg)
    floor = float(np.log(vocab))
    losses = []
    for s in range(20):
        b = lm_batch(s, 0, batch=8, seq=64, vocab=vocab, seed=0)
        jp, jst, jm = jstep(jp, jst, b)
        params, st, m = step(trainable(params), st,
                             {k: torch.from_numpy(v) for k, v in b.items()})
        ref, got = float(jm["loss"]), float(m["loss"])
        losses.append((ref, got))
        assert abs(ref - floor) < FULL_VOCAB_FLAT, (s, ref)
        assert abs(got - floor) < FULL_VOCAB_FLAT, (s, got)
    ref, got = losses[0]
    assert abs(got - ref) <= FULL_VOCAB_STEP1 * ref, (got, ref)
    print("full-vocab losses (reference, port), steps 1-20:", losses)

"""Power-intermittent training in the port (the paper's non-volatile full
adder adapted to a training step), on the CPU: with injected power
failures the final params equal an uninterrupted run's bit for bit, and a
restart resumes from the accumulation snapshot, not from the step's
start — the port's counterparts of ``tests/test_intermittent.py``, on the
LM smoke config and on ``svhn_cnn_spec(8)`` at W1A4.  Also the data
pipeline's determinism and host sharding against the reference's, the
synthetic arrays, and the checkpoint's restore device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import SINGLE  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.pipeline import Pipeline  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402
from repro_torch.train.intermittent import (  # noqa: E402
    IntermittentConfig, IntermittentTrainer, PowerFailure,
    deterministic_algorithms, run_with_failures)
from repro_torch.train.optimizer import OptConfig, tree_leaves  # noqa: E402

from test_torch_train_cnn import one_torch_thread  # noqa: E402,F401

VOCAB = 64


def _lm():
    cfg = configs.get_config("smollm-360m").smoke(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        vocab=VOCAB, head_dim=32)
    return (lambda: T.init_lm(torch.Generator().manual_seed(0), cfg, SINGLE,
                              device="cpu"),
            lambda p, b: T.lm_loss(p, b, cfg, SINGLE),
            lambda s, m: synthetic.lm_batch(s, m, batch=4, seq=16,
                                            vocab=VOCAB, seed=7),
            OptConfig(lr=1e-3))


def _cnn():
    spec = cnn.svhn_cnn_spec(8)

    def batch_fn(step, micro):
        x, y = synthetic.svhn_like(8, seed=step * 31 + micro)
        return dict(image=x, label=y)

    return (lambda: cnn.init_cnn(torch.Generator().manual_seed(0), spec),
            lambda p, b: cnn.cnn_loss(p, b, spec, quant.W1A4),
            batch_fn, OptConfig(lr=3e-3, warmup_steps=2, total_steps=10))


MODELS = {"lm": _lm, "cnn": _cnn}


def _make_trainer(model, tmpdir, fail_at=None):
    init, loss_fn, batch_fn, ocfg = MODELS[model]()
    icfg = IntermittentConfig(accum_steps=4, snapshot_every=2, full_every=2)
    ckpt = Checkpointer(tmpdir, keep=3, async_save=False)
    return IntermittentTrainer(loss_fn, init(), ocfg, batch_fn, ckpt, icfg,
                               fail_at=fail_at)


@pytest.mark.parametrize("model", ["lm", "cnn"])
def test_failure_mid_accumulation_bit_identical(model, tmp_path):
    with deterministic_algorithms():
        golden = _make_trainer(model, str(tmp_path / "g"))
        out_g = golden.train(4)
        # the SAME set goes to every incarnation (failures are the
        # environment's; each is discarded as it fires)
        fails = {(1, 3), (3, 1)}
        trainer, out, restarts = run_with_failures(
            lambda: _make_trainer(model, str(tmp_path / "c"), fail_at=fails),
            4)
    assert restarts == 2 and not fails
    assert trainer.step == golden.step == 4
    for a, b in zip(tree_leaves(golden.params), tree_leaves(trainer.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(golden.opt_state),
                    tree_leaves(trainer.opt_state)):
        assert torch.equal(a, b)
    assert out["loss"] == out_g["loss"] and np.isfinite(out["loss"])


@pytest.mark.parametrize("model", ["lm", "cnn"])
def test_restart_resumes_from_snapshot_not_step_start(model, tmp_path):
    """After failing at micro 3 (snapshot_every=2) the restart resumes at
    micro 2: the partial sums survive the power loss."""
    tr = _make_trainer(model, str(tmp_path / "s"), fail_at={(0, 3)})
    with pytest.raises(PowerFailure):
        tr.train(1)
    tr2 = _make_trainer(model, str(tmp_path / "s"))
    seen = []
    inner = tr2.batch_fn
    tr2.batch_fn = lambda s, m: seen.append((s, m)) or inner(s, m)
    assert tr2.restore()
    assert tr2._pending is not None and tr2._pending[1] == 2
    tr2.train(1)
    assert seen == [(0, 2), (0, 3)]
    # ... and lands where an uninterrupted step lands
    ref = _make_trainer(model, str(tmp_path / "r"))
    ref.train(1)
    for a, b in zip(tree_leaves(ref.params), tree_leaves(tr2.params)):
        assert torch.equal(a, b)


def test_uninterrupted_baseline_and_full_checkpoints(tmp_path):
    tr = _make_trainer("lm", str(tmp_path / "a"))
    out = tr.train(3)
    assert np.isfinite(out["loss"]) and tr.step == 3
    assert tr.ckpt.latest_step(tag="full") == 2
    assert tr.ckpt.latest_step(tag="accum") == 2
    assert all(p.requires_grad for p in tree_leaves(tr.params))


def test_restore_lands_on_the_template_device(tmp_path):
    """``Checkpointer.restore`` with no device puts each leaf on its
    template leaf's device (a CPU template here; the card's case is in
    ``test_torch_gpu.py``); an explicit device still wins."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    state = dict(w=torch.arange(6.0).reshape(2, 3),
                 s=torch.tensor(3, dtype=torch.int32))
    ck.save(1, state)
    _, back = ck.restore(state)
    assert back["w"].device.type == "cpu"
    assert torch.equal(back["w"], state["w"])
    _, back = ck.restore(dict(w=torch.empty(1, device="meta"),
                              s=torch.empty(1, dtype=torch.int32,
                                            device="meta")))
    assert back["w"].device.type == "cpu"
    _, back = ck.restore(state, device="meta")
    assert back["w"].device.type == "meta"


def test_pipeline_determinism_and_host_sharding_equal_reference():
    fn = lambda s, m: synthetic.lm_batch(s, m, batch=8, seq=8,  # noqa: E731
                                         vocab=32, seed=1)
    for host in (0, 1):
        p = Pipeline(fn, accum_steps=2, host_index=host, n_hosts=2).start(0)
        jp = jpipeline.Pipeline(fn, accum_steps=2, host_index=host,
                                n_hosts=2).start(0)
        try:
            for _ in range(5):
                (sm, b), (jsm, jb) = next(p), next(jp)
                assert sm == jsm
                assert b.keys() == jb.keys()
                for k in b:
                    assert b[k].shape == (4, 8)
                    np.testing.assert_array_equal(b[k], jb[k])
        finally:
            p.stop()
            jp.stop()
    a = Pipeline(fn, accum_steps=2, host_index=0, n_hosts=2).start(3)
    b = Pipeline(fn, accum_steps=2, host_index=0, n_hosts=2).start(3)
    try:
        (sa, ba), (sb, bb) = next(a), next(b)
        assert sa == sb == (3, 0)
        np.testing.assert_array_equal(ba["tokens"], bb["tokens"])
    finally:
        a.stop()
        b.stop()
    p = Pipeline(fn)
    assert (p.host, p.n_hosts) == (0, 1)   # no process group: one host


@pytest.mark.parametrize("size", [40, 24])
def test_synthetic_arrays_equal_reference(size):
    x, y = synthetic.svhn_like(17, seed=3, size=size)
    jx, jy = jsynthetic.svhn_like(17, seed=3, size=size)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(synthetic.lm_stream(300, 50, seed=1),
                                  jsynthetic.lm_stream(300, 50, seed=1))

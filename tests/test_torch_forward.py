"""Port parity: whole svhn and AlexNet forwards, reference plan (CPU,
jitted) against the port's ``cuda`` plan run on the CPU through the
kernels' plain versions, over the reference's own levels and scales.

Tolerance: equal argmax and max |dlogit| within twice the reference's OWN
jit-vs-eager drift on the same inputs (the same .5-boundary level flips,
inside the reference), with a floor of 2e-3 — about 0.5% of the logits'
scale here — for inputs where that drift happens to be zero.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import plan as jplan_mod  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from test_torch_cnn import _both_plans, _t  # noqa: E402

DRIFT_FLOOR = 2e-3


def _self_calibrated_tol(jp, x):
    # params as arguments: closed over, they would be baked into the
    # program as constants and slow its compile down
    ref = np.asarray(jax.jit(lambda p, v: jplan_mod.plan_forward(
        jp, v, params=p))(jp.params, x))
    eager = np.asarray(jplan_mod.plan_forward(jp, jnp.asarray(x)))
    return ref, max(2.0 * float(np.abs(ref - eager).max()), DRIFT_FLOOR)


@pytest.mark.parametrize("qname", ["w1a4", "w1a8"])
def test_full_width_svhn_logits_within_reference_drift(qname):
    jspec, tspec = jcnn.svhn_cnn_spec(), cnn.svhn_cnn_spec()
    jp, tp = _both_plans(jspec, tspec, qname, 40, 2, seed=11)
    assert [lp.engine for lp in tp.layers] == [
        "fp", "implicit", "implicit", "implicit", "implicit", "implicit",
        "fused", "fp"]
    x = np.random.RandomState(3).uniform(0, 1, (2, 40, 40, 3)).astype(
        np.float32)
    ref, tol = _self_calibrated_tol(jp, x)
    got = plan_mod.plan_forward(tp, _t(x)).numpy()
    assert got.shape == ref.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert np.abs(got - ref).max() <= tol


def test_alexnet_reduced_input_head_and_logits():
    """Full-width AlexNet at a 64x64 input (the test stays near 10 s; 224
    is what the card runs): the fp stride-4 stem, four implicit convs, the
    2 -> 6 resize, fc5 and fc6 on the fused kernel, fp fc7.

    With per-sample norm statistics a 1x1 map normalizes to beta, so the
    logits after fc5 do not depend on the image — in the reference too.
    The head (everything up to fc5's output, which does) carries the
    self-calibrated comparison; the logits must agree to the floor.
    """
    jspec, tspec = jcnn.alexnet_spec(), cnn.alexnet_spec()
    jp, tp = _both_plans(jspec, tspec, "w1a8", 64, 2, seed=4)
    assert [lp.engine for lp in tp.layers] == [
        "fp", "implicit", "implicit", "implicit", "implicit", "fused",
        "fused", "fp"]
    x = np.random.RandomState(9).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jplan_mod.plan_forward(
        jp, v, params=p))(jp.params, x))
    got = plan_mod.plan_forward(tp, _t(x)).numpy()
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert np.abs(got - ref).max() <= DRIFT_FLOOR

    head_j = jplan_mod.layers_for_batch(jp, 2)[:6]
    head_t = plan_mod.layers_for_batch(tp, 2)[:6]
    ref_h = np.asarray(jax.jit(lambda p, v: jplan_mod.execute_cnn_layers(
        head_j, p, v, jp.quant))(jp.params[:6], x))
    eager_h = np.asarray(jplan_mod.execute_cnn_layers(
        head_j, jp.params[:6], jnp.asarray(x), jp.quant))
    got_h = plan_mod.execute_cnn_layers(head_t, tp.params[:6], _t(x),
                                        tp.quant).numpy()
    tol_h = max(2.0 * float(np.abs(ref_h - eager_h).max()),
                DRIFT_FLOOR * float(np.abs(ref_h).max()))
    assert got_h.shape == (2, 4096) and np.isfinite(got_h).all()
    assert np.abs(got_h - ref_h).max() <= tol_h
